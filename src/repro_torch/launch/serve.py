"""Serving front end: batched LLM decode (prefill + greedy decode).

Counterpart of `repro/launch/serve.py` `serve` / `main_decode`:

    PYTHONPATH=src python -m repro_torch.launch.serve decode \\
        --arch llama3-8b --reduced --batch 4 --prompt-len 64 --gen 32 \\
        [--device cpu]

It runs on the CUDA card unless `--device` names another device; with no
card and no `--device` it fails.  On the card prefill's attention runs
the flash kernel and xLSTM's mLSTM chunks the mLSTM kernel.  The `fed`
subcommand (the async federation runtime) is not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models import transformer as tfm
from repro_torch.utils.device import resolve_device


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
          params=None, device=None, impl: Optional[str] = None):
    """Prefill `batch` Zipfian prompts of `prompt_len` tokens (seeded by
    `seed`, the reference's prompts), then decode `gen` tokens greedily.

    Weights are drawn from a `torch.Generator` seeded with `seed` on the
    device, or taken from `params` (e.g. `convert.params_from_reference`).
    `impl` routes prefill's kernels (see `models.transformer`).  Returns
    {prefill_s, decode_s, tok_per_s, generated (B, gen) numpy}; the
    device is synchronised before each clock reading."""
    device = resolve_device(device)
    with torch.inference_mode():
        if params is None:
            gen_ = torch.Generator(device=device).manual_seed(seed)
            params = tfm.init_params(cfg, gen_, device=device)
        prompts = torch.as_tensor(
            make_token_stream(cfg.vocab_size, batch, prompt_len, seed=seed),
            device=device)

        _sync(device)
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(cfg, params, prompts,
                                     max_seq=prompt_len + gen + 1, impl=impl)
        nxt = tfm.greedy_sample(logits)[:, None]
        _sync(device)
        t_prefill = time.perf_counter() - t0

        out_tokens = [nxt]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            pos = torch.full((batch,), prompt_len + i, dtype=torch.int32,
                             device=device)
            logits, caches = tfm.decode_step(cfg, params, caches, nxt, pos)
            nxt = tfm.greedy_sample(logits)[:, None]
            out_tokens.append(nxt)
        _sync(device)
        t_decode = time.perf_counter() - t0
        gen_ids = torch.cat(out_tokens, dim=1)
    return {"prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
            "generated": gen_ids.cpu().numpy()}


def main_decode(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="serve decode")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = resolve_device(args.device)
    print(f"serving {cfg.name} on {device}: batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    res = serve(cfg, args.batch, args.prompt_len, args.gen, args.seed,
                device=device)
    print(f"prefill {res['prefill_s']:.2f}s, decode {res['decode_s']:.2f}s"
          f" ({res['tok_per_s']:.1f} tok/s)")
    print("first generations:", res["generated"][:2, :16].tolist())
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # as in the reference, a bare flag invocation is `decode`
    if argv and argv[0] == "fed":
        print("serve fed (the async federation runtime) is not ported to "
              "repro_torch yet: ROADMAP Queue 1 (the async runtime)",
              file=sys.stderr)
        return 2
    if argv and argv[0] == "decode":
        argv = argv[1:]
    return main_decode(argv)


if __name__ == "__main__":
    raise SystemExit(main())
