"""End-to-end training driver: the federated trilevel AFTO step on an LLM.

Counterpart of `repro/launch/train.py` (the reference's "deliverable
(b)").  Trains a reduced or full-size model with the federated trilevel
AFTO step (`fed.trilevel_llm`), or plain AdamW for comparison, on
synthetic token streams, with checkpointing and loss logging.  Runs on
the card unless `--device cpu` is given.

`--engine scan` (the default) is a chunked host loop over the straggler
schedule precomputed up front: `--scan-chunk` master iterations a chunk
(default `--log-every`), with the reference's log and checkpoint
crossings at chunk ends (`_chunk_loop`); `--engine eager` is the
per-step loop.  Both run the same step and refresh on the same host
token batches, so they give the same bits.  `--stream` draws each
iteration's worker batches on the device from (key, iteration, worker)
(`trilevel_llm.batch_stream`), and the checkpoint carries the whole
restart carry (state, key, cursor), so `--resume` continues bit for bit.
The validation loss (worker 0's weights) runs under `torch.no_grad()`
on the default route, the card's kernels included; steps and refreshes
run the plain math, which they differentiate.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --reduced --steps 200 --mode afto --stream --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.core.scheduler import StragglerConfig, StragglerScheduler
from repro_torch.data import stream as stream_lib
from repro_torch.data.synthetic import make_token_stream
from repro_torch.fed.trilevel_llm import (FedHyper, afto_llm_step,
                                          batch_stream, cut_refresh_llm,
                                          init_fed_state, plain_train_step)
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_index, tree_leaves

_MESH = ("--mesh-workers is not ported yet: the LLM half of fed/sharding.py "
         "waits for a later slice (ROADMAP.md Queue 1, item 9)")


def _device(args) -> torch.device:
    return resolve_device(getattr(args, "device", None))


def _chunk_tokens(cfg, args, start: int, stop: int) -> np.ndarray:
    n, b, s = args.workers, args.batch, args.seq
    return np.stack([
        np.asarray(make_token_stream(cfg.vocab_size, n * b, s,
                                     seed=args.seed * 7919 + it))
        .reshape(n, b, s)
        for it in range(start, stop)])


def _step(cfg, args, hyper, st, batch, mask, it: int):
    """One master iteration and, on the refresh schedule, the cut
    refresh (the reference's `lax.cond`)."""
    st = afto_llm_step(cfg, hyper, st, batch, mask)
    if (it + 1) % args.t_pre == 0 and it < args.t1:
        st = cut_refresh_llm(cfg, hyper, st, batch)
    return st


def _worker0(state):
    return tree_index(state.X3, 0)


def _cuts(state) -> float:
    return float(torch.sum(state.cuts.active))


def run_afto_scan(cfg, args, hyper, state, sched, val_loss) -> dict:
    """Chunked trajectory over the precomputed schedule: `--scan-chunk`
    master iterations a chunk (default `--log-every`), losses and
    checkpoints at chunk ends (`_chunk_loop`)."""
    if args.mesh_workers:
        raise NotImplementedError(_MESH)
    schedule = sched.precompute(args.steps)
    chunk = max(1, args.scan_chunk or args.log_every)
    dev = tree_leaves(state)[0].device
    masks = torch.as_tensor(schedule.active, device=dev)
    if getattr(args, "stream", False):
        return _afto_scan_streamed(cfg, args, hyper, state, schedule,
                                   chunk, masks, val_loss)
    last_toks = None     # the live chunk's tokens, for the loss slice

    def one_chunk(st, start, stop):
        nonlocal last_toks
        toks = torch.as_tensor(_chunk_tokens(cfg, args, start, stop),
                               device=dev)
        last_toks = toks
        for i, it in enumerate(range(start, stop)):
            st = _step(cfg, args, hyper, st,
                       {"tokens": toks[i], "val_tokens": toks[i]},
                       masks[it], it)
        return st

    def loss_at(st, stop):
        return val_loss(_worker0(st), last_toks[-1][0])

    carry, start0 = _maybe_resume(args, {"state": state})
    return _chunk_loop(args, schedule, chunk, carry["state"], one_chunk,
                       loss_at, carry_to_save=lambda st: {"state": st},
                       start=start0)


def _maybe_resume(args, template):
    """(carry, start_step): the latest full-carry checkpoint of
    `--ckpt-dir` when `--resume` is set, else the template untouched.
    The carry is what `_chunk_loop` saved at a chunk end, so continuing
    from it is bit for bit the uninterrupted run (schedule masks and
    stream batches key on the absolute iteration)."""
    if not (getattr(args, "resume", False) and args.ckpt_dir):
        return template, 0
    step = latest_step(args.ckpt_dir)
    if step is None:
        return template, 0
    carry = load_checkpoint(args.ckpt_dir, template, step)
    print(json.dumps({"resumed_from": step, "ckpt_dir": args.ckpt_dir}))
    return carry, step


def _chunk_loop(args, schedule, chunk, state, one_chunk, loss_at,
                carry_to_save=None, start: int = 0) -> dict:
    """The chunk loop shared by the host-fed and streamed drivers: log
    whenever a `log_every` boundary was crossed inside the chunk (every
    chunk when chunk == log_every) or at the final, possibly partial,
    chunk, and save whenever a `ckpt_every` boundary was crossed.
    `one_chunk(state, start, stop)` advances the state; `loss_at(state,
    stop)` is worker 0's validation loss at iteration stop - 1;
    `carry_to_save(state)` is the checkpoint (z3 alone when unset).
    `start` > 0 continues a resumed run from that absolute step."""
    history = []
    t0 = time.time()
    for begin in range(start, args.steps, chunk):
        stop = min(begin + chunk, args.steps)
        state = one_chunk(state, begin, stop)
        if (stop // args.log_every > begin // args.log_every
                or stop == args.steps):
            history.append({"step": stop, "loss": float(loss_at(state, stop)),
                            "sim_time": float(schedule.sim_time[stop - 1]),
                            "host_s": round(time.time() - t0, 1),
                            "cuts": _cuts(state)})
            print(json.dumps(history[-1]))
        if args.ckpt_dir and \
                stop // args.ckpt_every > begin // args.ckpt_every:
            save_checkpoint(
                args.ckpt_dir,
                carry_to_save(state) if carry_to_save else state.z3,
                stop)
    return {"history": history, "state": state}


def _afto_scan_streamed(cfg, args, hyper, state, schedule, chunk, masks,
                        val_loss) -> dict:
    """The `--stream` driver: every iteration's worker batches are drawn
    on the device from (key, iteration, worker); the checkpoint holds
    (state, key, cursor), the whole restart carry."""
    stream = batch_stream(cfg, args.workers, args.batch, args.seq,
                          seed=args.seed)
    spec = stream.spec
    dev = masks.device
    carry, start0 = _maybe_resume(
        args, {"state": state, "key": np.uint64(stream.key),
               "cursor": np.int64(0)})
    state, key = carry["state"], int(carry["key"])
    cursor = int(carry["cursor"])

    def one_chunk(st, start, stop):
        nonlocal cursor
        for it in range(start, stop):
            batch = stream_lib.batch_at(spec, key, it, device=dev)
            st = _step(cfg, args, hyper, st, batch, masks[it], it)
        cursor = stop
        return st

    def loss_at(st, stop):
        # worker 0's tokens at iteration stop - 1
        toks = stream_lib.batch_at(spec, key, stop - 1, n_local=1,
                                   device=dev)["tokens"][0]
        return val_loss(_worker0(st), toks)

    def carry_to_save(st):
        return {"state": st, "key": np.uint64(key),
                "cursor": np.int64(cursor)}

    return _chunk_loop(args, schedule, chunk, state, one_chunk, loss_at,
                       carry_to_save=carry_to_save, start=start0)


def make_val_loss(cfg):
    """Worker 0's validation CE, a forward only: under `torch.no_grad()`
    on the default route, so the card runs its attention and mLSTM
    kernels."""
    def val_loss(w, toks):
        with torch.no_grad():
            return tfm.train_loss(cfg, w, toks, impl=None)
    return val_loss


def _afto_setup(cfg, args, state=None):
    """(hyper, state, sched, val_loss) for the AFTO drivers; `state`
    replaces the initial state drawn from `--seed` (tests start both
    packages from the reference's)."""
    n, b, s = args.workers, args.batch, args.seq
    hyper = FedHyper(n_workers=n, cut_mode=args.cut_mode,
                     sketch_r=args.sketch_r, p_max=2, k_inner=1,
                     remat=False, eta_x=args.lr, eta_z=args.lr)
    if state is None:
        dev = _device(args)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state = init_fed_state(cfg, hyper, gen, b, s - 1, device=dev)
    sched = StragglerScheduler(StragglerConfig(
        n_workers=n, s_active=max(1, n - 1), tau=args.tau,
        n_stragglers=1, seed=args.seed))
    return hyper, state, sched, make_val_loss(cfg)


def run_afto(cfg, args, state=None) -> dict:
    if args.mesh_workers:
        raise NotImplementedError(_MESH)
    hyper, state, sched, val_loss = _afto_setup(cfg, args, state)
    if args.engine == "scan":
        return run_afto_scan(cfg, args, hyper, state, sched, val_loss)
    if getattr(args, "stream", False):
        raise ValueError("--stream requires --engine scan")
    n, b, s = args.workers, args.batch, args.seq
    dev = tree_leaves(state)[0].device
    history = []
    t0 = time.time()
    for it in range(args.steps):
        toks = torch.as_tensor(make_token_stream(
            cfg.vocab_size, n * b, s, seed=args.seed * 7919 + it),
            device=dev).reshape(n, b, s)
        mask, sim_t = sched.next_active()
        state = _step(cfg, args, hyper, state,
                      {"tokens": toks, "val_tokens": toks},
                      torch.as_tensor(mask, device=dev), it)
        if (it + 1) % args.log_every == 0 or it == args.steps - 1:
            loss = float(val_loss(_worker0(state), toks[0]))
            history.append({"step": it + 1, "loss": loss,
                            "sim_time": sim_t,
                            "host_s": round(time.time() - t0, 1),
                            "cuts": _cuts(state)})
            print(json.dumps(history[-1]))
        if args.ckpt_dir and (it + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state.z3, it + 1)
    return {"history": history, "state": state}


def run_plain(cfg, args) -> dict:
    dev = _device(args)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tfm.init_params(cfg, gen, device=dev)
    opt = adamw(args.lr)
    opt_state = opt.init(params)
    history = []
    t0 = time.time()
    b = args.workers * args.batch
    for it in range(args.steps):
        toks = torch.as_tensor(make_token_stream(
            cfg.vocab_size, b, args.seq, seed=args.seed * 7919 + it),
            device=dev)
        params, opt_state, loss = plain_train_step(
            cfg, params, opt_state, toks, optimizer=opt, remat=False)
        if (it + 1) % args.log_every == 0 or it == args.steps - 1:
            history.append({"step": it + 1, "loss": float(loss),
                            "host_s": round(time.time() - t0, 1)})
            print(json.dumps(history[-1]))
        if args.ckpt_dir and (it + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, params, it + 1)
    return {"history": history, "params": params}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke variant (CPU-friendly)")
    ap.add_argument("--mode", default="afto", choices=["afto", "plain"])
    ap.add_argument("--engine", default="scan", choices=["scan", "eager"],
                    help="scan = chunked loop over the precomputed "
                         "schedule (default); eager = one step a loop turn")
    ap.add_argument("--cut-mode", default="sketch",
                    choices=["sketch", "exact"])
    ap.add_argument("--sketch-r", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2,
                    help="per-worker batch")
    ap.add_argument("--seq", type=int, default=129)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--t-pre", type=int, default=20)
    ap.add_argument("--t1", type=int, default=10_000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stream", action="store_true",
                    help="draw worker batches on the device from (key, "
                         "iteration, worker) (--engine scan); checkpoints "
                         "carry (state, key, cursor)")
    ap.add_argument("--scan-chunk", type=int, default=None,
                    help="master iterations a chunk (--engine scan); "
                         "defaults to --log-every")
    ap.add_argument("--mesh-workers", type=int, default=None,
                    help="not ported yet: raises (ROADMAP.md Queue 1, "
                         "item 9)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest full-carry checkpoint from "
                         "--ckpt-dir and continue from its step "
                         "(--engine scan; bit for bit the uninterrupted "
                         "run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (cpu runs "
                         "anywhere)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    print(f"training {cfg.name} mode={args.mode} steps={args.steps} "
          f"device={_device(args)} dtype={dtype_of(cfg.dtype)}")
    if args.mode == "afto":
        run_afto(cfg, args)
    else:
        run_plain(cfg, args)


if __name__ == "__main__":
    main()
