"""The worker mesh: one process per shard, joined by `torch.distributed`.

Counterpart of `repro/launch/mesh.py make_worker_mesh`.  The reference
shards the federation with `shard_map` over a one-axis device mesh
inside one program; PyTorch has no single-process SPMD, so here a shard
is a process (a rank) and the mesh is a process group.  Every rank calls
the same engine entry (`core.engine.run_scanned(mesh=)`, `run_chunked`,
`run_swept`) with the global problem and the mesh; each keeps its own
block of the workers and all the replicated master state, and each
returns the same global result.

    make_worker_mesh(n_shards, backend=None, device=None)
        -> WorkerMesh over ranks [0, n_shards) of an initialized job
           (a 1-shard mesh initializes its own one-process job).
    spawn_mesh("pkg.module:fn", n_shards, backend=, device=, args=)
        -> [fn(mesh, *args) of each rank], the ranks started as
           processes that rendezvous through a file in a temporary
           directory.

`WorkerMesh.all_reduce` is the counterpart of `lax.psum`: a sum over the
mesh of plain tensors, which counts the bytes it moves by label
(`core.sharded.traffic_record` predicts them).  It refuses to run inside
a `torch.func` transform: a collective there is taken for the identity
when the transform differentiates it, so the sharded engine assembles
its derivatives by hand around the collectives (`core.sharded`).

The backend is always the caller's or the device's default ("nccl" on
CUDA, "gloo" on the CPU), never switched on its own: a request the
machine cannot serve raises and names the alternative.  NCCL needs one
GPU per rank; ranks that share one card use "gloo", which stages CUDA
tensors through host memory.

The production meshes of the reference module are here as abstract
meshes (`AbstractMesh`: axis names and sizes, no devices), which the LLM
sharding rules (`fed.sharding.param_specs`) and the dry-run
(`launch.dryrun`) read: `make_production_mesh()` is the reference's
(16, 16) ("data", "model") pod and `make_production_mesh(multi_pod=
True)` its (2, 16, 16) ("pod", "data", "model") pair of pods.  Placing
tensors on a real `torch.distributed` device mesh of that layout waits
for the mesh-workers slice (ROADMAP.md Queue 1, item 9).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_unflatten

WORKER_AXIS = "worker"
BACKENDS = ("gloo", "nccl")
# intra-op threads of a rank: the ranks of a mesh share the host's cores
RANK_THREADS = 1

# The roofline's hardware: one NVIDIA H100 80GB HBM3 at its 700 W limit
# (NVIDIA's data sheet, SXM part, dense rates).  Both production meshes
# span more than one 8-GPU NVLink node on every axis, so a collective's
# rate is the node's InfiniBand link: NDR, 400 Gb/s per GPU.
PEAK_FLOPS_BF16 = 989e12       # FLOP/s per card, bf16 on the tensor cores
HBM_BW = 3.35e12               # bytes/s per card
LINK_BW = 50e9                 # bytes/s per card, NDR InfiniBand


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's layout without devices: `shape` maps each axis name to
    its size, in order."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: 16x16 = 256 cards (data, model).
    Multi-pod: 2x16x16 = 512 cards (pod, data, model)."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_debug_mesh(n_data: int = 2, n_model: int = 4) -> AbstractMesh:
    """A small (data, model) mesh."""
    return AbstractMesh(("data", "model"), (n_data, n_model))


@dataclasses.dataclass(eq=False)
class WorkerMesh:
    """One process's handle on a worker mesh.

    group      the `torch.distributed` process group of the mesh.
    rank       this process's shard index, None in a process of the job
               that is not in the mesh.
    size       the number of shards.
    axis_name  the mesh axis ("worker" for the engines).
    device     where this shard's tensors live.
    backend    "gloo" or "nccl".

    `traffic` / `calls` count the bytes and the collectives of
    `all_reduce` by label; with `profile` set, `seconds` adds the time
    spent in them, the device synchronised first."""
    group: Any
    rank: Optional[int]
    size: int
    axis_name: str = WORKER_AXIS
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    profile: bool = False
    traffic: Dict[str, int] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: self.size}

    @property
    def member(self) -> bool:
        return self.rank is not None

    def reset_traffic(self) -> None:
        self.traffic.clear()
        self.calls.clear()
        self.seconds.clear()

    def _sync(self):
        if self.profile and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _account(self, label: str, nbytes: int, t0: float) -> None:
        self.traffic[label] = self.traffic.get(label, 0) + nbytes
        self.calls[label] = self.calls.get(label, 0) + 1
        if self.profile:
            self.seconds[label] = self.seconds.get(label, 0.0) \
                + self._sync() - t0

    def all_reduce(self, **parts):
        """{label: tree} -> {label: the tree summed over the mesh}.

        All leaves travel in one collective per dtype (the payload is
        the sum of the leaves' bytes, as the reference's psums of the
        same trees); each label is charged its own leaves' bytes."""
        if torch._C._functorch.peek_interpreter_stack() is not None:
            raise RuntimeError(
                "WorkerMesh.all_reduce inside a torch.func transform: the "
                "transform would take the collective for the identity; "
                "reduce between the transformed pieces instead")
        labels = list(parts)
        flat = [tree_flatten(parts[k]) for k in labels]
        leaves = [(i, j, x) for i, (ls, _) in enumerate(flat)
                  for j, x in enumerate(ls)]
        out = [list(ls) for ls, _ in flat]
        t0 = self._sync()
        for dtype in dict.fromkeys(x.dtype for _, _, x in leaves):
            group = [(i, j, x) for i, j, x in leaves if x.dtype == dtype]
            buf = torch.cat([x.reshape(-1) for _, _, x in group])
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
            pieces = torch.split(buf, [x.numel() for _, _, x in group])
            for (i, j, x), p in zip(group, pieces):
                out[i][j] = p.reshape(x.shape)
        for i, k in enumerate(labels):
            nbytes = sum(x.numel() * x.element_size() for x in flat[i][0])
            self._account(k, nbytes, t0)
            t0 = time.perf_counter()
        return {k: tree_unflatten(flat[i][1], out[i])
                for i, k in enumerate(labels)}

    def all_gather(self, x: torch.Tensor, label: str = "gather"
                   ) -> List[torch.Tensor]:
        """Every shard's `x` (same shape on every shard), in rank order."""
        t0 = self._sync()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        self._account(label, x.numel() * x.element_size() * self.size, t0)
        return parts

    def broadcast_object(self, obj, src: int = 0):
        """`obj` of shard `src` on every shard (pickled; host values)."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def check_backend(n_shards: int, backend: str, device: torch.device) -> None:
    """Raise unless `backend` can serve `n_shards` ranks on `device`."""
    if n_shards < 1:
        raise ValueError(f"a worker mesh needs at least one shard, got "
                         f"{n_shards}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "gloo":
        return
    if device.type != "cuda":
        raise ValueError(
            f"backend 'nccl' runs on CUDA devices, not {device.type}; use "
            "backend='gloo' for a mesh on the CPU")
    visible = torch.cuda.device_count()
    if n_shards > visible:
        raise ValueError(
            f"backend 'nccl' needs one GPU per rank: {n_shards} ranks, "
            f"{visible} visible GPUs (NCCL refuses two ranks on one "
            "device); use backend='gloo' for ranks that share a GPU")
    if not dist.is_nccl_available():
        raise ValueError("this torch build has no NCCL; use backend='gloo'")


def _mesh_device(device: torch.device, backend: str, rank: int
                 ) -> torch.device:
    if device.type != "cuda" or device.index is not None:
        return device
    if backend == "nccl":
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return torch.device("cuda", torch.cuda.current_device())


def make_worker_mesh(n_shards: int, backend: Optional[str] = None,
                     device=None) -> WorkerMesh:
    """A one-axis ("worker") mesh over ranks [0, n_shards) of this job.

    Every process of the job calls it with the same arguments, in the
    same order (a mesh narrower than the job, or on another backend, is
    a new process group, which all ranks create together); a process
    outside the mesh gets a handle with `rank` None.  Without an
    initialized job a 1-shard mesh initializes a one-process job; wider
    meshes need their ranks started first (`spawn_mesh`, or
    `torch.distributed.init_process_group` in each).

    device: the shards' device, CUDA unless named (and then it raises
    without a card); backend: "nccl" on CUDA and "gloo" on the CPU
    unless named, and a request the machine cannot serve raises."""
    device = torch.device(device) if device is not None \
        else resolve_device(None)
    backend = default_backend(device) if backend is None else backend
    check_backend(n_shards, backend, device)
    if not dist.is_initialized():
        if n_shards != 1:
            raise ValueError(
                f"make_worker_mesh({n_shards}) needs {n_shards} processes: "
                "start them with repro_torch.launch.mesh.spawn_mesh, or "
                "call torch.distributed.init_process_group in each")
        if backend == "nccl":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_shards > world:
        raise ValueError(f"a {n_shards}-shard mesh in a job of {world} "
                         "processes")
    if n_shards == world and backend == dist.get_backend():
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks=list(range(n_shards)), backend=backend)
    member = rank < n_shards
    return WorkerMesh(
        group=group, rank=rank if member else None, size=n_shards,
        backend=backend,
        device=_mesh_device(device, backend, rank) if member else device)


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------

class MeshError(RuntimeError):
    """A rank of `spawn_mesh` failed, or the mesh outlived its deadline."""


def _src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def _kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def spawn_mesh(target: str, n_shards: int, backend: Optional[str] = None,
               device=None, args: Sequence = (), timeout: float = 600.0,
               pythonpath: Sequence[str] = ()) -> List[Any]:
    """Run `target(mesh, *args)` on `n_shards` ranks and return each
    rank's result, in rank order.

    target      "package.module:function", imported in each rank; the
                rank processes put this package's source root, then
                `pythonpath`, first on their path.
    args        pickled to the ranks (host values: numpy arrays, CPU
                tensors, dataclasses); each result comes back pickled.
    backend / device   as `make_worker_mesh`; the ranks of a "gloo" mesh
                on CUDA share the device, an "nccl" rank r takes GPU r.
    timeout     seconds for the whole run, and for any one collective:
                past it, or as soon as one rank fails, every rank is
                killed and `MeshError` raised with the failing rank's
                output.

    The ranks rendezvous through a `FileStore` in a fresh temporary
    directory (no TCP port to collide with), removed afterwards, and run
    one intra-op thread each (`RANK_THREADS`).  On
    CUDA the port's kernels are built here first, so that the ranks
    load the one build instead of running nvcc together."""
    device = torch.device(device) if device is not None \
        else resolve_device(None)
    backend = default_backend(device) if backend is None else backend
    check_backend(n_shards, backend, device)
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.load()
    tmp = tempfile.mkdtemp(prefix="worker_mesh_")
    procs: List[subprocess.Popen] = []
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump(dict(target=target, args=tuple(args),
                             backend=backend, device=str(device),
                             timeout=float(timeout),
                             pythonpath=[str(p) for p in pythonpath]), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_src_root(), *map(str, pythonpath),
             env.get("PYTHONPATH", "")])
        env["OMP_NUM_THREADS"] = str(RANK_THREADS)
        logs = [os.path.join(tmp, f"rank_{r}.log") for r in range(n_shards)]
        for r in range(n_shards):
            with open(logs[r], "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.mesh",
                     "--rank", str(r), "--world", str(n_shards),
                     "--dir", tmp], env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                _kill_all(procs)
                raise MeshError("\n".join(
                    f"rank {r} of {n_shards} exited {codes[r]}:\n"
                    f"{_tail(logs[r])}" for r in bad))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                _kill_all(procs)
                raise MeshError(
                    f"the {n_shards}-rank mesh ran past its {timeout:.0f} s "
                    f"deadline; rank 0's output:\n{_tail(logs[0])}")
            time.sleep(0.02)
        out = []
        for r in range(n_shards):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _kill_all(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, world: int, tmp: str) -> None:
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        call = pickle.load(f)
    sys.path[:0] = call["pythonpath"]
    torch.set_num_threads(RANK_THREADS)
    device = torch.device(call["device"])
    backend = call["backend"]
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=call["timeout"]))
    try:
        mesh = make_worker_mesh(world, backend=backend, device=device)
        module, _, name = call["target"].partition(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(mesh, *call["args"])
        # no rank leaves while another still reads from it
        dist.barrier()
        part = os.path.join(tmp, f"result_{rank}.pkl.part")
        with open(part, "wb") as f:
            pickle.dump(result, f)
        os.replace(part, os.path.join(tmp, f"result_{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="one rank of spawn_mesh")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--dir", required=True)
    a = p.parse_args(argv)
    try:
        _rank_main(a.rank, a.world, a.dir)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


if __name__ == "__main__":
    main()
