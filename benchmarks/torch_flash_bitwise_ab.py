#!/usr/bin/env python3
"""Bitwise A/B of the port's bf16 flash route at head dims 64 and 128
between two checkouts, on the card.

    python3 benchmarks/torch_flash_bitwise_ab.py OTHER_SRC

OTHER_SRC is the `src` directory of another checkout of the repository
(unpack it with `git archive <commit> | tar -x -C _checkout/other`).
Each tree runs in its own process, which builds that tree's kernels with
nvcc and writes to a temporary directory:

- `chip_smoke.py` phase 7's bf16 flash outputs at hd 128 and 64 (its
  `FLASH_SHAPES` and `FLASH_HD64_SHAPE`, the same operand seeds);
- phase 8's Llama-3 8B bf16 prefill logits (weights from seed 0, batch
  4, 1,024-token prompts, seed 0) and the kernel launches they took.

This process then holds each pair to `torch.equal` and exits 1 on any
difference.  Imports neither jax nor the reference package.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(src: str, out_dir: str) -> None:
    """Write this tree's outputs to `out_dir` (run in a child process)."""
    sys.path[:0] = [src, str(ROOT)]
    import torch
    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import build
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    lib = build.load()
    print(f"{src}: {build.library_path().name} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del lib
    out = {}
    with torch.inference_mode():
        for i, shape in enumerate(c.FLASH_SHAPES + (c.FLASH_HD64_SHAPE,)):
            o = c.flash_operands(shape, torch.bfloat16, seed=400 + i)
            K.reset_launches()
            out[f"flash {shape}"] = flash.flash_attention(
                o["q"], o["k"], o["v"], causal=True, window=shape[-1]).cpu()
            out[f"launches {shape}"] = dict(K.LAUNCHES)
        cfg = get_config("llama3-8b")
        params = tfm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
        prompts = torch.as_tensor(make_token_stream(
            cfg.vocab_size, c.SERVE_BATCH, c.SERVE_PROMPT, seed=0),
            device="cuda")
        K.reset_launches()
        out["llama3-8b logits"] = tfm.prefill(cfg, params, prompts)[0].cpu()
        out["launches llama3-8b"] = dict(K.LAUNCHES)
    torch.save(out, Path(out_dir) / "out.pt")


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--emit":
        emit(argv[1], argv[2])
        return 0
    if len(argv) != 1:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"this": str(ROOT / "src"), "other": str(Path(argv[0]).resolve())}
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, src in trees.items():
            d = Path(tmp) / label
            d.mkdir()
            subprocess.run([sys.executable, __file__, "--emit", src, str(d)],
                           check=True)
            outs[label] = torch.load(d / "out.pt")
    this, other = outs["this"], outs["other"]
    check(set(this) == set(other), "the two trees wrote different keys")
    same = True
    for key in this:
        if key.startswith("launches"):
            eq = this[key] == other[key]
            print(f"{key}: {this[key]} / {other[key]} "
                  f"({'equal' if eq else 'DIFFER'})")
        else:
            eq = torch.equal(this[key], other[key])
            print(f"{key}: torch.equal {eq} ({tuple(this[key].shape)}, "
                  f"{this[key].dtype})")
        same = same and eq
    print("bitwise equal: " + ("yes" if same else "NO"), flush=True)
    return 0 if same else 1


def check(ok: bool, msg: str) -> None:
    if not ok:
        print(f"FAIL: {msg}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
