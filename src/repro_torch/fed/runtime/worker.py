"""The worker endpoint: Eq. 16 gradient loop + subprocess CLI.

Counterpart of `repro/fed/runtime/worker.py`.  A worker owns its data
row.  It receives its local point (x1_j, x2_j, x3_j), differentiates its
objective f1 there (`torch.func.grad`, on the worker's device), pushes
the gradient triple, and repeats until STOP.  Its point changes only when
the master consumes one of its pushes, so between activations the local
copy is bitwise the master's row, and every pushed gradient is taken
where the single-process engine takes it.

Fault tolerance, the worker half of the protocol:

  - The session opens with `hello(worker, epoch)` (epoch 0 first, bumped
    on every reconnect), or `admit` for an id beyond the launch width.
  - While idle the worker sends HEARTBEATs every
    `FaultConfig.heartbeat_every`, so slow is never taken for gone, and
    retransmits an unacknowledged push every `resend_every`; pushes
    carry (epoch, seq), so the master consumes each at most once.
  - A REFRESH for a master iteration already acted on retransmits the
    push instead of recomputing it; a REFRESH without `t` is a protocol
    error and raises.  Corrupt frames are skipped: the retransmits
    recover them.

Streamed data (`stream=`): the worker draws its own row at the master
iteration `t` its REFRESH carries, which is its consumption time t_hat_j
when the master consumes the resulting push, so `batch_at(spec, key, t,
worker_offset=j, n_local=1)` gives the row the master and the engines
draw; no batch crosses the wire.

Every frame crosses as numpy: the rows come off the wire into fresh
tensors on the worker's device and the gradients leave it, so no tensor
is shared between a worker thread and the master.

`main()` is the multi-process entry (`python -m
repro_torch.fed.runtime.worker --problem quadratic --worker 0 --port
P [--device cpu]`): the worker rebuilds its problem by name from
`problems.py` and connects over TCP, reconnecting with capped
exponential backoff (seeded jitter) and an epoch bump whenever an
established session breaks.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.types import TrilevelProblem
from repro_torch.data import stream as stream_lib
from repro_torch.data.stream import Stream
from repro_torch.fed.runtime import messages as msg_lib
from repro_torch.fed.runtime import transport as transport_lib
from repro_torch.fed.runtime.membership import FaultConfig
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_index, tree_leaves, tree_map


def rows_to_device(rows, templates, device):
    """Wire rows (numpy trees) as tensors on `device` in the templates'
    dtypes."""
    return tuple(
        tree_map(lambda x, tpl: torch.as_tensor(x, dtype=tpl.dtype,
                                                device=device), r, t)
        for r, t in zip(rows, templates))


def row_grads(problem: TrilevelProblem, data_j, x1, x2, x3):
    """grad f1(data_j, .) at worker j's point: its Eq. 16 push."""
    with torch.no_grad():
        return tree_lib.grad(lambda a, b, c: problem.f1(data_j, a, b, c),
                             x1, x2, x3)


def worker_loop(problem: TrilevelProblem, worker: int,
                endpoint: transport_lib.WorkerEndpoint,
                max_pushes: Optional[int] = None,
                epoch: int = 0,
                fault: Optional[FaultConfig] = None,
                stream: Optional[Stream] = None,
                admit: bool = False,
                device=None) -> int:
    """Run worker `worker`'s loop until STOP (or `max_pushes`); returns
    the number of gradients pushed.  `epoch` is the session counter of
    the opening HELLO.  With `stream`, each refresh's row is drawn at the
    frame's master iteration `t`.  `admit=True` opens with ADMIT (an id
    beyond the launch population) and idles until WELCOME and the
    initial rows arrive.  `device` is where the gradients are taken (the
    CUDA card unless named); the problem must live there.

    Raises `ConnectionError` if the transport breaks mid-session: the
    caller (supervisor thread, CLI reconnect loop) owns the retry."""
    fault = fault or FaultConfig()
    device = resolve_device(device)
    for leaf in tree_leaves((problem.x1_init, problem.data)):
        if leaf.device.type != device.type:
            raise ValueError(f"the problem lives on {leaf.device}, the "
                             f"worker on {device}")
    templates = (problem.x1_init, problem.x2_init, problem.x3_init)

    if stream is None:
        data_j = tree_index(problem.data, worker)

        def batch_row(t):
            return data_j
    else:
        spec, base_key = stream.spec, stream.key

        def batch_row(t):
            return tree_index(stream_lib.batch_at(
                spec, base_key, t, worker_offset=worker, n_local=1,
                device=device), 0)

    opening = (msg_lib.admit(worker, epoch) if admit
               else msg_lib.hello(worker, epoch))
    endpoint.send(msg_lib.encode(opening))
    n_pushes = 0
    last_t = -1                 # newest master iteration acted on
    last_push_frame: Optional[bytes] = None   # unacked push, for resends
    last_push_tx = 0.0

    def push_current() -> None:
        nonlocal last_push_tx
        if last_push_frame is not None:
            endpoint.send(last_push_frame)
            last_push_tx = time.monotonic()

    while max_pushes is None or n_pushes < max_pushes:
        frame = endpoint.recv(timeout=fault.heartbeat_every)
        if frame is None:
            # idle: retransmit an unacked push, else beacon liveness
            if last_push_frame is not None and \
                    time.monotonic() - last_push_tx > fault.resend_every:
                push_current()
            else:
                endpoint.send(msg_lib.encode(
                    msg_lib.heartbeat(worker, epoch)))
            continue
        try:
            m = msg_lib.decode(frame)
        except Exception:
            continue            # corrupt frame; retransmits recover it
        if m.kind == msg_lib.STOP:
            break
        if m.kind == msg_lib.WELCOME:
            continue            # the initial rows follow
        if m.kind != msg_lib.REFRESH:
            raise ValueError(f"worker got unexpected {m.kind!r} message")
        if "t" not in m.meta:
            # a missing `t` read as 0 would look like a duplicate and
            # wedge the worker retransmitting a stale push forever
            raise ValueError(
                f"worker {worker} got a REFRESH without a master "
                f"iteration 't' in its meta {m.meta!r}; refusing to "
                "treat an unstamped frame as a duplicate")
        t = int(m.meta["t"])
        if t <= last_t:
            # our push for this point was lost: the rows are unchanged,
            # so retransmit rather than recompute
            push_current()
            continue
        last_t = t
        x1, x2, x3 = rows_to_device(msg_lib.refresh_rows(m, templates),
                                    templates, device)
        grads = row_grads(problem, batch_row(t), x1, x2, x3)
        n_pushes += 1
        last_push_frame = msg_lib.encode(
            msg_lib.push(worker, n_pushes, grads, epoch=epoch))
        push_current()
    endpoint.close()
    return n_pushes


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Subprocess worker entry (TCP) with a reconnect loop: capped
    exponential backoff with seeded jitter on a refused connection, and
    an epoch bump whenever an established session breaks."""
    from repro_torch.fed.runtime import problems as problems_lib

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--problem", default="quadratic",
                   help="problem registry name (problems.py)")
    p.add_argument("--worker", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--n-workers", type=int, default=2)
    p.add_argument("--dim", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epoch", type=int, default=0,
                   help="starting session epoch (a respawned worker "
                        "passes its previous epoch + 1)")
    p.add_argument("--stream", action="store_true",
                   help="draw batches from the problem's registered "
                        "stream instead of its static data")
    p.add_argument("--device", default=None,
                   help="device to compute on (default: the CUDA card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    # an id at or beyond the launch width is a late worker: it builds
    # the problem wide enough to hold its own row (registry rows are
    # stable under width) and opens with ADMIT
    admit = args.worker >= args.n_workers
    build_n = max(args.n_workers, args.worker + 1)
    problem, _ = problems_lib.build(args.problem, n_workers=build_n,
                                    dim=args.dim, seed=args.seed,
                                    device=device)
    stream = (problems_lib.build_stream(
        args.problem, n_workers=build_n, dim=args.dim,
        seed=args.seed) if args.stream else None)
    # one gradient before connecting: the process's first one (CUDA
    # context, library handles, torch.func) can take longer than the
    # master's death deadline on a busy host, and the master's clock
    # starts at the connection
    templates = (problem.x1_init, problem.x2_init, problem.x3_init)
    row_grads(problem, tree_index(problem.data, args.worker), *templates)
    fault = FaultConfig()
    rng = np.random.default_rng((args.seed, args.worker))
    epoch = args.epoch
    tries = 0
    while True:
        try:
            endpoint = transport_lib.TcpTransport.connect(
                args.host, args.port, args.worker, epoch=epoch,
                admit=admit)
        except OSError:
            tries += 1
            if tries > fault.backoff_tries:
                raise
            delay = min(fault.backoff_cap,
                        fault.backoff_base * 2.0 ** (tries - 1))
            time.sleep(delay * (0.5 + float(rng.random())))
            continue
        tries = 0
        try:
            worker_loop(problem, args.worker, endpoint, epoch=epoch,
                        fault=fault, stream=stream, admit=admit,
                        device=device)
            return 0
        except (ConnectionError, OSError):
            # an established session broke: the next one is a new epoch
            epoch += 1
            time.sleep(fault.backoff_base)


if __name__ == "__main__":
    raise SystemExit(main())
