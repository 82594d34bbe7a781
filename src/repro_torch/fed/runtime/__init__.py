"""Real asynchronous federation runtime on the port.

Counterpart of `repro/fed/runtime/`.  The engines (`repro_torch.core.
engine`) SIMULATE asynchrony from a materialized `Schedule`; this package
is the real thing: a master endpoint that owns the canonical state on
its device (the `FlatCuts` polytopes, the z variables, the duals) and
`hyper.n_workers` worker endpoints that each compute their Eq. 16
gradient at their own pace and push it over a serialized message layer.
The master consumes pushes under the paper's S-of-N / tau arrival rule,
applies the master half of the step (`core.afto.afto_step_from_grads`)
with the cut kernels on the card, and records the live arrival process
as a `Schedule` (`core.scheduler.ArrivalRecorder`).

Layering:

  messages.py   the wire format (json header + npz leaves, no pickle),
                byte-identical to the reference's frames.
  transport.py  `InProcTransport` (queues, deterministic) and
                `TcpTransport` (length-prefixed frames, reconnect
                accepts, broken connections surfaced as DISCONNECT).
  membership.py `FaultConfig`, `Membership` (failure detector, sessions),
                exact resharding (`make_views` / `assemble_state`),
                growth (`grow_state`) and `run_scanned_elastic`.
  master.py     the arrival rule and step loop (`Master`, `run_async`):
                liveness deadlines, durable checkpoint / resume.
  worker.py     the worker loop (heartbeats, retransmits) and the
                reconnecting subprocess CLI.
  chaos.py      seeded fault injection (`ChaosScript`) and the
                supervised crash / rejoin harness (`run_chaos_async`).
  problems.py   name -> (problem, hyper) registry, so subprocess
                workers rebuild the same closures and data.

Contracts: a live run's recorded Schedule replays through the runtime
bit for bit (chaos, resumed and widened runs included), and through
`run_scanned` within float tolerance (the engine takes one gradient of
sum_j f1 over the stacked rows, a worker its own row's).
"""
from repro_torch.fed.runtime.chaos import (ChaosCrash, ChaosScript,
                                           run_chaos_async)
from repro_torch.fed.runtime.master import Master, run_async
from repro_torch.fed.runtime.membership import (FaultConfig, Membership,
                                                assemble_state, make_views,
                                                reshard_state)
from repro_torch.fed.runtime.messages import Message, decode, encode
from repro_torch.fed.runtime.transport import InProcTransport, TcpTransport

__all__ = ["Master", "run_async", "Message", "encode", "decode",
           "InProcTransport", "TcpTransport",
           "FaultConfig", "Membership", "make_views", "assemble_state",
           "reshard_state", "ChaosScript", "ChaosCrash",
           "run_chaos_async"]
