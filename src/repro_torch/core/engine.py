"""Trajectory engines: a whole single-device AFTO run, or R of them at
once, as one host loop.

Counterpart of `repro/core/engine.py` `run_scanned`, `run_chunked` and
`run_swept` (single device).  The reference compiles the trajectory into
one `lax.scan`, and a sweep into one `jax.vmap` of it; here each
iteration is eager PyTorch on the device, and the loop keeps the device
free of host round trips:

  * the schedule's arrival masks are copied to the device once;
  * `afto_step` runs every master iteration (Eqs. 16-21);
  * `cut_refresh` runs on every t_pre-th iteration with t < t1
    (Eqs. 23-25), decided on a host-side mirror of the post-step `t`
    (the step adds exactly 1), so no device sync per iteration;
  * at `metrics_every` strides the stationarity gap reuses the step's
    cut operator and cut values, recomputed only after a refresh;
  * recorded values stay on the device until the run ends.

`data=` replaces `problem.data` with other arrays, or with a
`repro_torch.data.stream.Stream`: each iteration's worker batches are
then drawn on the device, worker j's row keyed on its pre-step
consumption time `state.stale.t_hat[j]`, and the step, the refresh and
the recorded gap of that iteration all see the same batch.  The engine
keeps a host mirror of `t_hat`, read from the state once a call and
advanced from the host's arrival masks as the step advances the state's
(`afto.afto_step_aux`), so drawing a batch needs no device sync.  Both
the refresh predicate and the batches key on absolute counters carried
by the state, so `run_chunked`, any chunk partition of a run into
state-continued calls, gives the unchunked run bit for bit.

`run_swept` runs R trajectories in the same loop through
`torch.func.vmap` of the same step, refresh and record, every state leaf
with a leading run axis: every cut contraction and fused round is one
batched kernel launch for all R runs (`kernels.cut_ad`'s vmap rules).
A stream is shared by the runs: each run draws its batch at its own
`t_hat` mirror, outside the transform.

All three take `mesh=`, a `launch.mesh.WorkerMesh`: every shard (a
process) calls the engine with the same global arguments, runs its block
of the workers through `core.sharded` (the step, refresh and gap split
into local pieces and sums over the mesh; a sweep vmaps the local
pieces), and returns the global state gathered from every shard.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core import afto as afto_lib
from repro_torch.core import sharded as sharded_lib
from repro_torch.core import stationarity as stat_lib
from repro_torch.core.scheduler import Schedule
from repro_torch.core.types import AFTOState, Hyper, TrilevelProblem
from repro_torch.data import stream as stream_lib
from repro_torch.data.stream import Stream
from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class RunResult:
    state: AFTOState
    history: Dict
    # the live arrival process of an async run; None for scheduled runs
    arrivals: Any = None


@dataclasses.dataclass
class SweepResult:
    """R trajectories from one sweep: every state leaf and per-run
    history array carries a leading (R,) axis ("t" is shared)."""
    state: AFTOState
    history: Dict

    @property
    def n_runs(self) -> int:
        return int(self.state.t.shape[0])

    def run(self, r: int) -> RunResult:
        """Row r as a RunResult with the single-run history layout."""
        state_r = pytree.tree_map(lambda x: x[r], self.state)
        hist_r = {k: (v[r] if np.ndim(v) == 2 else v)
                  for k, v in self.history.items()}
        return RunResult(state=state_r, history=hist_r)


def record_slots(n_iterations: int,
                 metrics_every: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side record layout matching the eager runner.

    Returns (record_its, slots): `record_its` are the iterations whose
    metrics are recorded — every `metrics_every`-th plus the final one —
    and `slots[it]` is the history row for iteration `it` (-1 when
    iteration `it` records nothing)."""
    record_its = np.array(
        [it for it in range(n_iterations)
         if (it + 1) % metrics_every == 0 or it == n_iterations - 1],
        dtype=np.int64)
    slots = np.full((n_iterations,), -1, np.int32)
    slots[record_its] = np.arange(len(record_its), dtype=np.int32)
    return record_its, slots


def refresh_due(hyper: Hyper, t_post: int) -> bool:
    """The refresh predicate on the 1-based post-step iteration count."""
    return t_post % hyper.t_pre == 0 and t_post - 1 < hyper.t1


def record(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
           metrics_fn: Optional[Callable], aux=None) -> Dict:
    """One history row as 0-d device tensors."""
    vals = {
        "gap_sq": stat_lib.stationarity_gap_sq(problem, hyper, state,
                                               aux=aux),
        "n_cuts_i": torch.sum(state.cuts_i.active),
        "n_cuts_ii": torch.sum(state.cuts_ii.active),
    }
    if metrics_fn is not None:
        vals.update(metrics_fn(state))
    return vals


def _check_stream(stream: Stream, hyper: Hyper) -> None:
    if stream.spec is None:
        raise ValueError("Stream has no spec; build it with "
                         "repro_torch.data.stream.make_stream")
    if stream.spec.n_workers != hyper.n_workers:
        raise ValueError(
            f"the stream spans {stream.spec.n_workers} workers but "
            f"hyper.n_workers={hyper.n_workers}")


def problem_device(problem: TrilevelProblem) -> torch.device:
    """The device the problem's tensors live on (its runs run there)."""
    return tree_leaves(problem.x1_init)[0].device


def bind_data(problem: TrilevelProblem, hyper: Hyper, data):
    """(problem, stream): `data` arrays replace `problem.data` (as
    tensors on the problem's device); a `Stream` is checked and returned
    for the engine to draw from."""
    if data is None:
        return problem, None
    if isinstance(data, Stream):
        _check_stream(data, hyper)
        return problem, data
    device = problem_device(problem)
    return dataclasses.replace(problem, data=tree_map(
        lambda x: torch.as_tensor(x if torch.is_tensor(x) else np.array(x),
                                  device=device), data)), None


def advance_t_hat(t_hat: np.ndarray, active: np.ndarray,
                  t_post) -> np.ndarray:
    """The host mirror of `state.stale.t_hat` after a step: a worker whose
    update arrived was handed the post-step point, as in `afto_step_aux`
    (`t_hat = where(active > 0, t + 1, t_hat)`)."""
    return np.where(np.asarray(active) > 0, np.asarray(t_post)[..., None]
                    if np.ndim(t_post) else t_post, t_hat)


def run_scanned(problem: TrilevelProblem, hyper: Hyper, schedule: Schedule,
                metrics_fn: Optional[Callable] = None,
                metrics_every: int = 10,
                state: Optional[AFTOState] = None,
                data=None, mesh=None) -> RunResult:
    """Run the AFTO trajectory over `schedule`.

    The history holds numpy arrays keyed by t / sim_time / host_time /
    gap_sq / n_cuts_i / n_cuts_ii / max_staleness plus any `metrics_fn`
    keys (whose values are 0-d tensors).  `host_time` is prorated from
    the run's total, as in the reference.  A `state` continues a run:
    the refresh predicate keys on the absolute iteration count, and a
    stream on each worker's absolute consumption time.

    data: replacement `problem.data` arrays, or a `Stream` whose batches
    are drawn each iteration at the workers' pre-step `t_hat`.

    mesh: a `launch.mesh.WorkerMesh` with a "worker" axis; every shard
    calls this with the same global arguments and runs its own block of
    the workers (`_run_sharded`), and every shard returns the same
    global result.  `hyper.n_workers` must divide over the mesh."""
    if mesh is not None:
        return _run_sharded(problem, hyper, schedule, metrics_fn,
                            metrics_every, state, data, mesh)
    n_iterations = schedule.n_iterations
    problem, stream = bind_data(problem, hyper, data)
    if state is None:
        state = afto_lib.init_state(problem, hyper)
    device = state.lam.device
    record_its, slots = record_slots(n_iterations, metrics_every)
    active = np.asarray(schedule.active)
    masks = torch.as_tensor(active, dtype=torch.float32, device=device)
    rows = []

    t_start = time.perf_counter()
    t_abs = int(state.t)
    t_hat = None if stream is None else \
        state.stale.t_hat.cpu().numpy().astype(np.int64)
    prob = problem
    with torch.no_grad():
        for it in range(n_iterations):
            if stream is not None:
                prob = problem      # let the last batch go before the next
                prob = dataclasses.replace(problem, data=stream_lib.next_batch(
                    stream, t_hat, device=device))
                t_hat = advance_t_hat(t_hat, active[it], t_abs + 1)
            state, aux = afto_lib.afto_step_aux(prob, hyper, state,
                                                masks[it])
            t_abs += 1
            refreshed = refresh_due(hyper, t_abs)
            if refreshed:
                state = afto_lib.cut_refresh(prob, hyper, state)
            if slots[it] >= 0:
                rows.append(record(prob, hyper, state, metrics_fn,
                                   aux=None if refreshed else aux))
        history = {k: torch.stack([r[k].float() for r in rows])
                   .cpu().numpy() for k in rows[0]}
    elapsed = time.perf_counter() - t_start

    return RunResult(state=state, history=_finish_history(
        history, schedule, record_its, elapsed))


def _finish_history(history, schedule, record_its, elapsed) -> Dict:
    n_iterations = schedule.n_iterations
    history["t"] = (record_its + 1).astype(np.float64)
    history["sim_time"] = np.asarray(schedule.sim_time)[record_its]
    history["max_staleness"] = np.asarray(
        schedule.max_staleness)[record_its].astype(np.float64)
    history["host_time"] = elapsed * (record_its + 1) / n_iterations
    return history


# ---------------------------------------------------------------------------
# worker-mesh sharded runs: one process per shard
# ---------------------------------------------------------------------------

_ENGINE_KEYS = ("gap_sq", "n_cuts_i", "n_cuts_ii")


def _check_mesh(mesh, hyper: Hyper) -> int:
    """The mesh's width, after checking its axis, its divisibility of the
    workers and that this process is one of its shards."""
    shape = dict(mesh.shape)
    if sharded_lib.WORKER_AXIS not in shape:
        raise ValueError(
            f"mesh must carry a {sharded_lib.WORKER_AXIS!r} axis; got axes "
            f"{tuple(shape)} (see repro_torch.launch.mesh.make_worker_mesh)")
    w = shape[sharded_lib.WORKER_AXIS]
    if hyper.n_workers % w != 0:
        raise ValueError(f"n_workers={hyper.n_workers} must divide over the "
                         f"{w}-shard worker mesh")
    if not mesh.member:
        raise ValueError("this process is not a shard of the mesh")
    return w


def _shared_history(history: Dict, mesh) -> Dict:
    """The engine's keys are the same on every shard; a `metrics_fn` key,
    computed on the shard-local state, is shard 0's on every shard."""
    extra = {k: v for k, v in history.items() if k not in _ENGINE_KEYS}
    if extra:
        history.update(mesh.broadcast_object(extra))
    return history


def _run_sharded(problem, hyper, schedule, metrics_fn, metrics_every,
                 state, data, mesh) -> RunResult:
    """`run_scanned` on a worker mesh: this shard's block of the state,
    data rows and mask columns through `core.sharded`, every other
    shard doing the same, then the global state gathered from all.

    A stream draws only this shard's global worker rows (at offset
    rank * n_local), so streaming adds no traffic; `metrics_fn` sees the
    shard-local state (shard 0's values are recorded, as the reference
    records the replicated-out buffer)."""
    from repro_torch.fed import sharding as shd

    n_shards = _check_mesh(mesh, hyper)
    n_iterations = schedule.n_iterations
    problem, stream = bind_data(problem, hyper, data)
    if state is None:
        state = afto_lib.init_state(problem, hyper)
    device = state.lam.device
    spec_i, spec_ii = state.cuts_i.spec, state.cuts_ii.spec
    w = mesh.rank
    n_loc = hyper.n_workers // n_shards
    off = w * n_loc
    local_prob = shd.shard_problem(problem, w, n_shards)
    record_its, slots = record_slots(n_iterations, metrics_every)
    active = np.asarray(schedule.active)[:, off:off + n_loc]
    masks = torch.as_tensor(active, dtype=torch.float32, device=device)
    rows = []

    t_start = time.perf_counter()
    with torch.no_grad():
        local = shd.shard_state(state, w, n_shards)
        del state
        t_abs = int(local.t)
        t_hat = None if stream is None else \
            local.stale.t_hat.cpu().numpy().astype(np.int64)
        loc = sharded_lib.Local(local_prob, hyper, mesh)
        for it in range(n_iterations):
            if stream is not None:
                loc = None      # let the last batch go before the next
                loc = sharded_lib.Local(dataclasses.replace(
                    local_prob, data=stream_lib.next_batch(
                        stream, t_hat, worker_offset=off, n_local=n_loc,
                        device=device)), hyper, mesh)
                t_hat = advance_t_hat(t_hat, active[it], t_abs + 1)
            local, aux = sharded_lib.afto_step_sharded(loc, local,
                                                       masks[it])
            t_abs += 1
            refreshed = refresh_due(hyper, t_abs)
            if refreshed:
                local = sharded_lib.refresh_sharded(loc, local)
            if slots[it] >= 0:
                rows.append(sharded_lib.record_sharded(
                    loc, local, metrics_fn, aux=None if refreshed else aux))
        history = {k: torch.stack([r[k].float() for r in rows])
                   .cpu().numpy() for k in rows[0]}
        state = shd.gather_state(local, mesh, spec_i, spec_ii)
    elapsed = time.perf_counter() - t_start
    return RunResult(state=state, history=_finish_history(
        _shared_history(history, mesh), schedule, record_its, elapsed))


def _stitch_histories(parts, offsets, elapsed_offsets) -> Dict:
    """Per-chunk histories as one record of absolute iterations: "t"
    shifts by each chunk's start, `host_time` adds the time spent before
    the chunk."""
    out: Dict = {}
    for k in parts[0]:
        segs = []
        for h, off, el in zip(parts, offsets, elapsed_offsets):
            v = np.asarray(h[k])
            if k == "t":
                v = v + off
            elif k == "host_time":
                v = v + el
            segs.append(v)
        out[k] = np.concatenate(segs)
    return out


def run_chunked(problem: TrilevelProblem, hyper: Hyper, schedule: Schedule,
                chunk_size: int,
                chunk_hook: Optional[Callable] = None,
                metrics_fn: Optional[Callable] = None,
                metrics_every: int = 10,
                state: Optional[AFTOState] = None,
                data=None, mesh=None) -> RunResult:
    """`run_scanned` split into state-continued calls of `chunk_size`
    iterations, with `chunk_hook(state, t_abs)` called on the live state
    at every chunk boundary, the final one included (`t_abs` counts the
    iterations of `schedule` run so far).

    The hook may return a replacement state (None keeps it): the seam to
    push state out (write a checkpoint, ship cut rows to a master) and
    pull state in before the next chunk.  A hook that returns None gives
    the unchunked run bit for bit: the refresh predicate and the streamed
    batches key on the state's absolute counters.

    The history records per chunk (every `metrics_every`-th iteration of
    the chunk and its last), stitched to absolute iterations.  On a
    worker `mesh` each chunk is a sharded `run_scanned`, and the hook
    sees the global state assembled from every shard (it must return the
    same replacement on every shard)."""
    n_iterations = schedule.n_iterations
    chunk_size = max(1, int(chunk_size))
    parts, offsets, elapsed = [], [], []
    spent = 0.0
    for a in range(0, n_iterations, chunk_size):
        b = min(a + chunk_size, n_iterations)
        res = run_scanned(problem, hyper, schedule.slice(a, b),
                          metrics_fn=metrics_fn,
                          metrics_every=metrics_every, state=state,
                          data=data, mesh=mesh)
        state = res.state
        parts.append(res.history)
        offsets.append(a)
        elapsed.append(spent)
        spent += float(res.history["host_time"][-1])
        if chunk_hook is not None:
            replacement = chunk_hook(state, b)
            if replacement is not None:
                state = replacement
    return RunResult(state=state,
                     history=_stitch_histories(parts, offsets, elapsed))


# ---------------------------------------------------------------------------
# sweeps: R trajectories through one vmapped loop
# ---------------------------------------------------------------------------

# Hyper fields that fix shapes or loop lengths, as in the reference
# (`repro/core/engine.py:192`), and fields that are not numbers; neither
# can be swept
_STATIC_HYPER_FIELDS = frozenset({"n_workers", "p_max", "k_inner", "d1"})
_NON_NUMERIC_FIELDS = frozenset({"use_fused_inner", "cut_impl"})
# the fused round's step sizes are kernel arguments (static arguments of
# the reference's kernel), shared by every run of a batched launch
_FUSED_STEP_FIELDS = frozenset({"eta_z", "eta_s", "eta_dual_inner", "rho2"})


def _check_sweep_hypers(hyper: Hyper, sweep_hypers, n_runs: int):
    """{name: (R,) numpy values} of the swept Hyper fields, validated."""
    fields = {f.name for f in dataclasses.fields(Hyper)}
    out = {}
    for name, vals in dict(sweep_hypers or {}).items():
        if name not in fields:
            raise ValueError(f"unknown hyper field {name!r}")
        if name in _STATIC_HYPER_FIELDS:
            raise ValueError(
                f"hyper field {name!r} is shape-determining and cannot be "
                "swept; run separate sweeps instead")
        if name in _NON_NUMERIC_FIELDS:
            raise ValueError(f"hyper field {name!r} is not a number and "
                             "cannot be swept")
        if hyper.use_fused_inner and name in _FUSED_STEP_FIELDS:
            raise ValueError(
                f"hyper field {name!r} is a step size of the fused round "
                "(use_fused_inner=True), shared by the runs of a batched "
                "launch, and cannot be swept")
        vals = np.asarray(vals.detach().cpu() if torch.is_tensor(vals)
                          else vals)
        if vals.shape != (n_runs,):
            raise ValueError(f"sweep_hypers[{name!r}] must have shape "
                             f"({n_runs},), got {vals.shape}")
        out[name] = vals
    return out


def _stack_runs(tree, n_runs: int, device, what: str):
    """A private copy of a caller's (R,)-leading tree on `device`."""
    def copy(x):
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)):
            raise ValueError(
                f"run_swept: {what} leaf of type {type(x).__name__}: the "
                "leaves must be tensors or arrays (streamed data is a "
                "Stream in place of the whole data tree)")
        x = torch.as_tensor(x, device=device)
        if x.shape[:1] != (n_runs,):
            raise ValueError(f"swept {what} leaves need a leading "
                             f"({n_runs},) axis, got {tuple(x.shape)}")
        return x.clone()
    return pytree.tree_map(copy, tree)


def run_swept(problem: TrilevelProblem, hyper: Hyper,
              schedules: Sequence[Schedule],
              metrics_fn: Optional[Callable] = None,
              metrics_every: int = 10,
              states: Optional[AFTOState] = None,
              data=None,
              sweep_hypers: Optional[Mapping] = None,
              mesh=None) -> SweepResult:
    """Run R = len(schedules) whole trajectories at once.

    Each iteration runs `torch.func.vmap` of `run_scanned`'s step (and
    refresh, and record) over a leading run axis: stacked initial states,
    stacked schedule masks, per-run data and per-run hyper scalars; the
    iteration and record strides are shared.  All schedules must have the
    same length and worker count.

      states       optional stacked `AFTOState` ((R,)-leading leaves);
                   defaults to R copies of `init_state`.  Copied: the
                   caller's tensors are never changed.
      data         optional replacement for `problem.data` with a leading
                   (R,) axis per leaf (per-seed datasets), copied to the
                   problem's device; or a `Stream`, shared by the runs:
                   each run draws its batch at its own `t_hat` mirror,
                   the data a `run_scanned(data=stream)` of its schedule
                   sees, and the (R, N, ...) batch rides the vmapped
                   step as per-run data.
      sweep_hypers {Hyper field: (R,) values}: each run's value rides its
                   step as a 0-d tensor.  Shape-determining fields
                   (n_workers/p_max/k_inner/d1) cannot be swept, nor,
                   with `use_fused_inner`, the fused round's step sizes.
                   Sweeping t_pre/t1 (or states at different t) makes the
                   refresh predicate per run: the refresh then runs for
                   every run on any iteration one run is due and each
                   run keeps its own branch (`torch.where`), as the
                   reference's vmapped `lax.cond` lowers to a select.

      mesh         a worker mesh as in `run_scanned`: each shard runs
                   its block of every run's workers, the local pieces
                   of each stage vmapped over the runs and the sums over
                   the mesh acting on the stacked (R, ...) aggregates
                   between stages (`core.sharded.Local`).

    History layout: per-run keys (gap_sq, n_cuts_*, sim_time,
    max_staleness, host_time, metrics_fn keys) are (R, n_records)
    arrays; "t" is shared (n_records,).  `host_time` charges each run an
    equal 1/R share of the loop's elapsed time, prorated over
    iterations as in the single-run engine (the runs interleave, so
    per-run host seconds do not exist)."""
    schedules = list(schedules)
    if not schedules:
        raise ValueError("run_swept needs at least one schedule")
    n_runs = len(schedules)
    n_iterations = schedules[0].n_iterations
    for s in schedules[1:]:
        if (s.n_iterations, s.n_workers) != (n_iterations,
                                             schedules[0].n_workers):
            raise ValueError(
                "all swept schedules must share n_iterations/n_workers")
    swept = _check_sweep_hypers(hyper, sweep_hypers, n_runs)
    device = problem_device(problem)

    if states is None:
        st0 = afto_lib.init_state(problem, hyper)
        state = pytree.tree_map(
            lambda x: x[None].expand((n_runs,) + tuple(x.shape)).clone(),
            st0)
    else:
        state = _stack_runs(states, n_runs, device, "state")
    stream = None
    if isinstance(data, Stream):
        _check_stream(data, hyper)
        stream, data = data, None
    elif data is not None:
        data = _stack_runs(data, n_runs, device, "data")
    values = {k: torch.as_tensor(
        v, dtype=torch.float32 if v.dtype.kind == "f" else torch.int64,
        device=device) for k, v in swept.items()}
    # the refresh predicate per run, on host mirrors of each run's t
    t_pre = np.broadcast_to(swept.get("t_pre", hyper.t_pre), (n_runs,))
    t1 = np.broadcast_to(swept.get("t1", hyper.t1), (n_runs,))
    t_abs = state.t.cpu().numpy().astype(np.int64)
    t_hat = None if stream is None else \
        state.stale.t_hat.cpu().numpy().astype(np.int64)

    def bind(fn):
        """fn(problem, hyper, state, *rest) vmapped over the runs, called
        as (run_data, state, *rest)."""
        def one(vals, run_data, st, *rest):
            prob = problem if run_data is None else \
                dataclasses.replace(problem, data=run_data)
            # each run's swept values ride as 0-d tensors
            return fn(prob, dataclasses.replace(hyper, **vals), st, *rest)

        def call(run_data, *args, rest_dims=()):
            dims = (0 if values else None,
                    None if run_data is None else 0, 0) + rest_dims
            return torch.func.vmap(one, in_dims=dims)(values, run_data,
                                                      *args)
        return call

    step = bind(afto_lib.afto_step_aux)
    refresh = bind(afto_lib.cut_refresh)
    rec = bind(lambda prob, hyp, st, aux: record(prob, hyp, st, metrics_fn,
                                                 aux=aux))

    record_its, slots = record_slots(n_iterations, metrics_every)
    active = np.stack([np.asarray(s.active) for s in schedules], 1)
    off, n_loc = 0, None
    if mesh is not None:
        from repro_torch.fed import sharding as shd

        n_shards = _check_mesh(mesh, hyper)
        n_loc = hyper.n_workers // n_shards
        off = mesh.rank * n_loc
        active = active[..., off:off + n_loc]
        spec_i, spec_ii = state.cuts_i.spec, state.cuts_ii.spec
        state = torch.func.vmap(
            lambda st: shd.shard_state(st, mesh.rank, n_shards))(state)
        if t_hat is not None:
            t_hat = t_hat[:, off:off + n_loc]
        if data is not None:
            data = shd.shard_data(data, mesh.rank, n_shards, dim=1)
        local_prob = shd.shard_problem(problem, mesh.rank, n_shards)

        def local(run_data):
            return sharded_lib.Local(local_prob, hyper, mesh, batched=True,
                                     values=values, data=run_data)

        def step(run_data, st, mask, rest_dims=()):
            return sharded_lib.afto_step_sharded(local(run_data), st, mask)

        def refresh(run_data, st):
            return sharded_lib.refresh_sharded(local(run_data), st)

        def rec(run_data, st, aux, rest_dims=()):
            return sharded_lib.record_sharded(local(run_data), st,
                                              metrics_fn, aux)
    masks = torch.as_tensor(active, dtype=torch.float32, device=device)
    rows = []
    t_start = time.perf_counter()
    with torch.no_grad():
        for it in range(n_iterations):
            if stream is not None:
                # drawn outside vmap, which refuses random ops; the last
                # batch goes first
                data = None
                data = stream_lib.next_batch(stream, t_hat,
                                             worker_offset=off,
                                             n_local=n_loc, device=device)
                t_hat = advance_t_hat(t_hat, active[it], t_abs + 1)
            state, aux = step(data, state, masks[it], rest_dims=(0,))
            t_abs += 1
            due = (t_abs % t_pre == 0) & (t_abs - 1 < t1)
            if due.all():
                state = refresh(data, state)
            elif due.any():
                fresh = refresh(data, state)
                keep = torch.as_tensor(due, device=device)
                state = pytree.tree_map(
                    lambda new, old: torch.where(
                        keep.reshape((-1,) + (1,) * (new.dim() - 1)),
                        new, old), fresh, state)
            if slots[it] >= 0:
                # a refresh rewrote the polytope: the gap recomputes the
                # step's cut products (for every run: same numbers)
                rows.append(rec(data, state, None, rest_dims=(None,))
                            if due.any() else
                            rec(data, state, aux, rest_dims=(0,)))
        history = {k: torch.stack([r[k].float() for r in rows], 1)
                   .cpu().numpy() for k in rows[0]}
        if mesh is not None:
            state = shd.gather_state(state, mesh, spec_i, spec_ii, lead=1)
            history = _shared_history(history, mesh)
    elapsed = time.perf_counter() - t_start

    history["t"] = (record_its + 1).astype(np.float64)
    history["sim_time"] = np.stack(
        [np.asarray(s.sim_time)[record_its] for s in schedules])
    history["max_staleness"] = np.stack(
        [np.asarray(s.max_staleness)[record_its].astype(np.float64)
         for s in schedules])
    history["host_time"] = np.broadcast_to(
        (elapsed / n_runs) * (record_its + 1) / n_iterations,
        (n_runs, len(record_its))).copy()
    return SweepResult(state=state, history=history)
