"""Serving front end: batched LLM decode and the async federation runtime.

Counterpart of `repro/launch/serve.py`.  Two subcommands:

  decode   prefill + greedy decode of a batch of prompts:
      PYTHONPATH=src python -m repro_torch.launch.serve decode \\
          --arch llama3-8b --reduced --batch 4 --prompt-len 64 --gen 32 \\
          [--device cpu]
      (a bare flag invocation routes here too.)  On the card prefill's
      attention runs the flash kernel and xLSTM's mLSTM chunks the mLSTM
      kernel.  Whisper (`--arch whisper-large-v3`) is served on random
      frame embeddings, as in the reference.

  fed      one async federation run: a master plus N workers over the
           in-process transport (threads) or TCP (worker subprocesses,
           `python -m repro_torch.fed.runtime.worker`), printing one
           JSON line per record and optionally serving GET /status:
      PYTHONPATH=src python -m repro_torch.launch.serve fed \\
          --problem quadratic --workers 2 --iters 60 --transport tcp \\
          [--device cpu]
      Exits nonzero unless the gap decreased and the recorded staleness
      kept the tau bound; `--stream` runs on streamed data and gates the
      recorded schedule's replay through `run_scanned` instead of the
      decrease; `--adapt-arrivals` turns on the arrival policy;
      `--max-workers` admits late workers.

Both run on the CUDA card unless `--device` names another device; with
no card and no `--device` they fail.  TCP workers get the same
`--device`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models import transformer as tfm
from repro_torch.utils.device import resolve_device


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_frames(cfg, batch: int, seed: int, device):
    """`serve`'s frame embeddings for a frame-frontend arch: (batch,
    encoder_seq, d_model) bf16 normals from a `torch.Generator` seeded
    `seed + 1` on `device`; None for a token-frontend arch."""
    if cfg.frontend != "frames":
        return None
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return torch.randn((batch, cfg.encoder_seq, cfg.d_model), device=device,
                       generator=gen).to(torch.bfloat16)


def serve(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
          params=None, device=None, impl: Optional[str] = None,
          frames=None):
    """Prefill `batch` Zipfian prompts of `prompt_len` tokens (seeded by
    `seed`, the reference's prompts), then decode `gen` tokens greedily.

    Weights are drawn from a `torch.Generator` seeded with `seed` on the
    device, or taken from `params` (e.g. `convert.params_from_reference`).
    A frame-frontend arch (Whisper) also takes (batch, encoder_seq,
    d_model) frame embeddings: `frames`, or `draw_frames` (the reference
    draws them from `PRNGKey(seed + 1)`).  `impl` routes prefill's
    kernels (see `models.transformer`).  Returns {prefill_s, decode_s,
    tok_per_s, generated (B, gen) numpy}; the device is synchronised
    before each clock reading."""
    device = resolve_device(device)
    with torch.inference_mode():
        if params is None:
            gen_ = torch.Generator(device=device).manual_seed(seed)
            params = tfm.init_params(cfg, gen_, device=device)
        prompts = torch.as_tensor(
            make_token_stream(cfg.vocab_size, batch, prompt_len, seed=seed),
            device=device)
        if frames is None:
            frames = draw_frames(cfg, batch, seed, device)

        _sync(device)
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(cfg, params, prompts, frames,
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


# ---------------------------------------------------------------------------
# fed: master + N workers over a live transport
# ---------------------------------------------------------------------------

# seconds a worker process may take to exit after the run
WORKER_EXIT_S = 60.0


def start_status_server(master, port: int):
    """Serve `master.status` as JSON on GET /status (daemon thread);
    returns the HTTPServer (its bound port is `.server_address[1]`)."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.rstrip("/") not in ("", "/status"):
                self.send_error(404)
                return
            body = json.dumps(master.status).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):   # keep the run's stdout clean
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def worker_command(args, port: int, worker: int,
                   epoch: int = 0) -> List[str]:
    """The command line of one `repro_torch.fed.runtime.worker`
    subprocess for the run `args` describes (the same problem knobs,
    stream and device)."""
    cmd = [sys.executable, "-m", "repro_torch.fed.runtime.worker",
           "--problem", args.problem, "--port", str(port),
           "--n-workers", str(args.workers),
           "--dim", str(args.dim), "--seed", str(args.seed),
           "--worker", str(worker), "--epoch", str(epoch)]
    if getattr(args, "stream", False):
        cmd.append("--stream")
    if getattr(args, "device", None):
        cmd += ["--device", str(args.device)]
    return cmd


def worker_env() -> dict:
    """The environment of a worker subprocess: this package's source
    root first on PYTHONPATH."""
    env = dict(os.environ)
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def spawn_tcp_workers(args, port: int) -> List[subprocess.Popen]:
    """One worker subprocess per worker id, pointed at the master's bound
    port (each rebuilds the problem by name)."""
    env = worker_env()
    return [subprocess.Popen(worker_command(args, port, j), env=env)
            for j in range(args.workers)]


def run_fed(args):
    """Launch the run described by parsed `fed` args; returns
    (RunResult, status_server | None).  Worker subprocesses are waited
    for at most `WORKER_EXIT_S` seconds after the run, then killed (and
    the run fails)."""
    from repro_torch.core.scheduler import ArrivalPolicy
    from repro_torch.fed.runtime import problems as problems_lib
    from repro_torch.fed.runtime import run_async
    from repro_torch.fed.runtime.membership import FaultConfig
    from repro_torch.fed.runtime.transport import TcpTransport

    device = resolve_device(args.device)
    problem, hyper = problems_lib.build(
        args.problem, n_workers=args.workers, dim=args.dim,
        seed=args.seed, device=device)
    stream = None
    if args.stream:
        # TCP subprocess workers rebuild this identical Stream by name
        stream = problems_lib.build_stream(
            args.problem, n_workers=args.workers, dim=args.dim,
            seed=args.seed)
    policy = None
    if args.adapt_arrivals:
        policy = ArrivalPolicy(s_active=hyper.s_active, tau=hyper.tau)
    elastic = None
    max_workers = getattr(args, "max_workers", 0)
    if max_workers > args.workers:
        # accept ADMITs from ids [workers, max_workers): a worker started
        # with `--worker J`, J >= --workers, joins at the next boundary
        elastic = problems_lib.elastic_config(
            args.problem, max_workers, dim=args.dim, seed=args.seed,
            stream=bool(args.stream), device=device)

    transport, procs = None, []
    if args.transport == "tcp":
        transport = TcpTransport(args.workers, port=args.port,
                                 max_workers=max(max_workers,
                                                 args.workers))
        transport.master_endpoint()          # bind before spawning
        print(f"master listening on 127.0.0.1:{transport.port}",
              flush=True)
        procs = spawn_tcp_workers(args, transport.port)

    fault = FaultConfig(death_timeout=args.death_timeout,
                        min_iter_time=args.min_iter_time)
    status_server = None

    def hook(master):
        nonlocal status_server
        if args.status_port >= 0:
            status_server = start_status_server(master, args.status_port)
            print(f"status endpoint: http://127.0.0.1:"
                  f"{status_server.server_address[1]}/status", flush=True)

    try:
        result = run_async(
            problem, hyper, n_iterations=args.iters,
            metrics_every=args.metrics_every, transport=transport,
            data=stream, policy=policy, master_hook=hook, fault=fault,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            resume=args.resume, elastic=elastic, device=device,
            accept_timeout=(args.accept_timeout
                            if args.accept_timeout > 0 else None))
    finally:
        stuck = []
        for p in procs:
            try:
                p.wait(timeout=WORKER_EXIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                stuck.append(p.args)
    if stuck:
        raise RuntimeError(f"worker processes did not exit: {stuck}")
    return result, status_server


def fed_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="serve fed")
    ap.add_argument("--problem", default="quadratic")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--metrics-every", type=int, default=10)
    ap.add_argument("--transport", choices=("inproc", "tcp"),
                    default="inproc")
    ap.add_argument("--max-workers", type=int, default=0,
                    help="accept elastic ADMITs for worker ids below this "
                         "cap (0 = fixed membership); a late worker "
                         "connects with --worker >= --workers and joins "
                         "at the next iteration boundary")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP master port (0 = ephemeral)")
    ap.add_argument("--status-port", type=int, default=-1,
                    help="HTTP status port (0 = ephemeral, -1 = off)")
    ap.add_argument("--accept-timeout", type=float, default=0.0,
                    help="seconds to wait for the full worker population "
                         "at launch (0 = wait forever)")
    ap.add_argument("--death-timeout", type=float, default=10.0,
                    help="seconds of silence before a worker is "
                         "declared dead")
    ap.add_argument("--min-iter-time", type=float, default=0.0,
                    help="master pacing floor per iteration (seconds)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for durable master checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the master carry every K "
                         "iterations (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --ckpt-dir "
                         "before running")
    ap.add_argument("--stream", action="store_true",
                    help="streamed data: workers draw their own rows at "
                         "the refresh's master iteration; the run exits "
                         "nonzero unless the recorded schedule replays "
                         "through run_scanned")
    ap.add_argument("--adapt-arrivals", action="store_true",
                    help="adapt the effective (s, tau) per iteration "
                         "inside the paper's tau bound")
    ap.add_argument("--device", default=None,
                    help="device of the master and the workers (default: "
                         "the CUDA card)")
    return ap


def main_fed(argv: Optional[Sequence[str]] = None) -> int:
    args = fed_parser().parse_args(argv)
    result, status_server = run_fed(args)
    for i, t in enumerate(result.history["t"]):
        print(json.dumps({
            "t": int(t),
            "gap_sq": float(result.history["gap_sq"][i]),
            "n_cuts_ii": float(result.history["n_cuts_ii"][i]),
            "max_staleness": float(result.history["max_staleness"][i])}))
    if status_server is not None:
        status_server.shutdown()

    gaps = result.history["gap_sq"]
    # a streamed run measures each gap on a fresh batch, so first vs
    # last is batch noise: its gate is the replay echo below
    decreasing = bool(args.stream) or gaps[-1] < gaps[0]
    max_stale = int(result.arrivals.max_staleness.max())
    stale_ok = max_stale <= _problem_tau(args)
    trend = ("streamed (per-batch)" if args.stream
             else "decreasing" if decreasing else "NOT decreasing")
    print(f"gap {gaps[0]:.4f} -> {gaps[-1]:.4f} ({trend}); "
          f"max recorded staleness {max_stale} "
          f"(tau bound {'ok' if stale_ok else 'VIOLATED'})")
    replay_ok = True
    if args.stream:
        replay_ok = _streamed_replay_gate(args, result)
    return 0 if (decreasing and stale_ok and replay_ok) else 1


def _streamed_replay_gate(args, result) -> bool:
    """Echo a streamed run's recorded Schedule through `run_scanned` (the
    segmented elastic replay for a widened run) with the rebuilt Stream
    and gate the gap history at relative error 1e-5.  The engine takes
    one gradient of sum_j f1 where a worker takes its own row's, so the
    floor is float rounding, not 0.0; the bitwise contract is replay
    through the runtime."""
    from repro_torch.core.engine import run_scanned
    from repro_torch.fed.runtime import problems as problems_lib
    from repro_torch.fed.runtime.membership import run_scanned_elastic

    device = resolve_device(args.device)

    def build(n):
        return problems_lib.build(args.problem, n_workers=n, dim=args.dim,
                                  seed=args.seed, device=device)

    def build_stream(n):
        return problems_lib.build_stream(args.problem, n_workers=n,
                                         dim=args.dim, seed=args.seed)

    if result.arrivals.width is not None:
        ref = run_scanned_elastic(build, result.arrivals,
                                  metrics_every=args.metrics_every,
                                  build_stream=build_stream)
    else:
        problem, hyper = build(args.workers)
        ref = run_scanned(problem, hyper, result.arrivals,
                          metrics_every=args.metrics_every,
                          data=build_stream(args.workers))
    live = np.asarray(result.history["gap_sq"], np.float64)
    echo = np.asarray(ref.history["gap_sq"], np.float64)
    if live.shape != echo.shape:
        print(f"streamed replay gate: history shape mismatch "
              f"{live.shape} vs {echo.shape}")
        return False
    rel = float(np.max(np.abs(live - echo) /
                       np.maximum(np.abs(echo), 1e-30)))
    ok = rel <= 1e-5
    print(f"streamed replay gate: max gap rel err {rel:.3e} "
          f"({'ok' if ok else 'EXCEEDS 1e-5'})")
    return ok


def _problem_tau(args) -> int:
    from repro_torch.fed.runtime import problems as problems_lib
    _, hyper = problems_lib.build(args.problem, n_workers=args.workers,
                                  dim=args.dim, seed=args.seed,
                                  device="cpu")
    return hyper.tau


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # as in the reference, a bare flag invocation is `decode`
    if argv and argv[0] == "fed":
        return main_fed(argv[1:])
    if argv and argv[0] == "decode":
        argv = argv[1:]
    return main_decode(argv)


if __name__ == "__main__":
    raise SystemExit(main())
