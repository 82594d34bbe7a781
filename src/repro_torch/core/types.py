"""Core state containers for AFTO.

Counterpart of `repro/core/types.py`; notation follows the paper:
  x_{i,j}  - worker j's local copy of level-i variables  -> stacked trees
             with a leading worker axis N ("X1", "X2", "X3").
  z_i      - master consensus variables                  -> plain trees.
  theta_j  - duals for the consensus constraint x_{1,j}=z1 (Eq. 14).
  lambda_l - duals for the II-layer polytope cuts (Eq. 14).
  P_I/P_II - hyper-polyhedral cut sets (fixed capacity + active mask;
             Add/Drop write rows, Eq. 25).

Trees are dicts, lists or tensors (see `repro_torch.utils.tree`).  Cut
storage is the canonical flat `FlatCuts`: one dense `(P, D)` f32
coefficient matrix plus `c`/`active`/`age` rows and a `FlatSpec` column
layout.  Every function that updates a state returns a new one and
leaves its argument untouched, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.core.scheduler import validate_arrival_params
from repro_torch.utils.tree import tree_index


@dataclasses.dataclass
class Hyper:
    """Algorithm hyper-parameters."""
    n_workers: int = 4
    s_active: int = 3           # S: master proceeds after S worker updates
    tau: int = 10               # max staleness
    k_inner: int = 4            # K communication rounds for phi estimates
    p_max: int = 8              # cut-set capacity per layer
    t_pre: int = 10             # add cuts every t_pre master iterations
    t1: int = 200               # stop adding cuts after t1 iterations
    # step sizes (paper Eq. 5-7, 16-21)
    eta_x: float = 0.05
    eta_z: float = 0.05
    eta_lambda: float = 0.05
    eta_theta: float = 0.05
    eta_dual_inner: float = 0.05   # eta_phi for the inner ADMM duals
    eta_s: float = 0.05            # slack update step (level-2 inner)
    # penalties (Eq. 4, 11)
    kappa2: float = 1.0
    kappa3: float = 1.0
    rho2: float = 1.0
    # relaxation + weak-convexity constants (Eq. 23/24)
    eps_i: float = 1e-3
    eps_ii: float = 1e-3
    mu_i: float = 0.1
    mu_ii: float = 0.1
    # variable bound constants, ||x_i||^2 <= alpha_i (Assumption 4.4)
    alpha1: float = 100.0
    alpha2: float = 100.0
    alpha3: float = 100.0
    alpha4: float = 100.0       # lambda in [0, sqrt(alpha4)]
    alpha5: float = 100.0       # ||theta||_inf <= sqrt(alpha5)/d1
    # regularization floors c_1, c_2 (Eq. 15)
    c1_floor: float = 1e-3
    c2_floor: float = 1e-3
    d1: int = 1                 # dim of x1 (for the theta projection radius)
    # run each level-2 inner round's cut algebra in the fused round
    # kernel (`kernels.ops.fused_cut_round`)
    use_fused_inner: bool = False
    # route of every cut contraction and fused round (the impl of
    # `kernels.ops.cut_eval` / `fused_cut_round`): None = the CUDA
    # kernels on CUDA tensors, the plain version on the CPU; "ref"
    # forces the plain version (the on-card oracle run)
    cut_impl: Optional[str] = None

    def __post_init__(self):
        # a swept hyper holds a per-run 0-d tensor (`engine.run_swept`);
        # only concrete ints are judged, as in the reference
        if all(isinstance(v, int) for v in
               (self.n_workers, self.s_active, self.tau)):
            validate_arrival_params(self.s_active, self.tau,
                                    self.n_workers, what="Hyper")

    def c1(self, t):
        return _reg_weight(self.c1_floor, self.eta_lambda, t)

    def c2(self, t):
        return _reg_weight(self.c2_floor, self.eta_theta, t)


def _reg_weight(floor: float, eta: float, t):
    """max(floor, 1 / (eta (t+1)^{1/4})) in f32 at a 0-d int tensor t."""
    tf = t.to(torch.float32)
    return torch.clamp(1.0 / (eta * (tf + 1.0) ** 0.25), min=floor)


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Column layout of the flattened cut coefficient space.

    Per-leaf entries run over the concatenated leaves of the five blocks
    (a1, a2, a3, b2, b3) in order; `shapes` are the *point* shapes (b-block
    shapes keep the worker axis).  Frozen and hashable."""
    tdefs: Tuple[Any, ...]          # one treedef per block
    nleaves: Tuple[int, ...]        # leaves per block
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    d_total: int


@dataclasses.dataclass
class FlatCuts:
    """Canonical cut storage: the polytope as one dense (P, D) operator.

    a      : (P, D) f32 coefficient matrix; row l is cut l's flattened
             (a1, a2, a3, b2, b3) blocks in `spec` column order.
    c      : (P,) offsets;  active: (P,) {0,1};  age: (P,) int32 insertion
             time (-1 for a never-written row).
    spec   : `FlatSpec` column layout.
    """
    a: torch.Tensor
    c: torch.Tensor
    active: torch.Tensor
    age: torch.Tensor
    spec: Any = None


@dataclasses.dataclass
class InnerState3:
    """Level-3 inner ADMM state (Eq. 4-8): x3'_j, z3', duals phi3_j."""
    x3: Any        # (N, ...) stacked
    z3: Any
    phi: Any       # (N, ...) stacked duals


@dataclasses.dataclass
class InnerState2:
    """Level-2 inner ADMM state (Eq. 11): x2'_j, z2', duals phi2_j,
    slacks s_l >= 0 and cut multipliers gamma_l for the I-layer polytope."""
    x2: Any
    z2: Any
    phi: Any
    s: torch.Tensor       # (P,)
    gamma: torch.Tensor   # (P,)


@dataclasses.dataclass
class StaleView:
    """Per-worker snapshots of the master state taken at each worker's last
    active iteration t_hat_j (Eq. 16's L_p^{t_hat_j})."""
    z1: Any              # (N, ...) stacked
    z2: Any
    z3: Any
    lam: torch.Tensor    # (N, P)
    theta: Any           # (N, ...) own dual snapshot
    t_hat: torch.Tensor  # (N,) int32 — last active iteration per worker


@dataclasses.dataclass
class AFTOState:
    X1: Any              # (N, ...) worker-local variables
    X2: Any
    X3: Any
    z1: Any
    z2: Any
    z3: Any
    theta: Any           # (N, ...) consensus duals (Eq. 14)
    lam: torch.Tensor    # (P,) II-layer cut duals
    cuts_i: FlatCuts     # I-layer polytope
    cuts_ii: FlatCuts    # II-layer polytope
    gamma_k: torch.Tensor  # (P,) last inner gamma (drop rule, Eq. 25)
    inner3: InnerState3    # warm-started level-3 inner state
    inner2: InnerState2    # warm-started level-2 inner state
    stale: StaleView
    t: torch.Tensor        # master iteration counter (0-d int32)


@dataclasses.dataclass(frozen=True)
class TrilevelProblem:
    """A distributed trilevel problem (Eq. 2/3).

    f1/f2/f3 are *per-worker* objectives with signature
        f(data_j, x1, x2, x3) -> scalar tensor
    where data_j is worker j's slice of `data` (leading axis N per leaf).
    The global objective at each level is the sum over workers.
    """
    f1: Callable
    f2: Callable
    f3: Callable
    data: Any
    n_workers: int
    x1_init: Any
    x2_init: Any
    x3_init: Any

    def worker_data(self, j: int):
        return tree_index(self.data, j)

    def sum_f(self, f, X1, X2, X3):
        """sum_j f(data_j, x1_j, x2_j, x3_j) with stacked per-worker args."""
        return sum_workers(
            self.n_workers,
            lambda j: f(self.worker_data(j), tree_index(X1, j),
                        tree_index(X2, j), tree_index(X3, j)))


def _register_pytrees():
    """Make the state containers pytrees of `torch.utils._pytree`, so
    `torch.func.vmap` maps over their tensor leaves (the sweep engine's
    run axis); a `FlatCuts`' column layout `spec` is static context."""
    for cls in (InnerState3, InnerState2, StaleView, AFTOState):
        names = tuple(f.name for f in dataclasses.fields(cls))
        pytree.register_pytree_node(
            cls,
            lambda x, names=names: ([getattr(x, n) for n in names], None),
            lambda children, _ctx, cls=cls, names=names: cls(
                **dict(zip(names, children))),
            serialized_type_name=f"repro_torch.core.types.{cls.__name__}")
    pytree.register_pytree_node(
        FlatCuts,
        lambda fc: ([fc.a, fc.c, fc.active, fc.age], fc.spec),
        lambda children, spec: FlatCuts(*children, spec=spec),
        serialized_type_name="repro_torch.core.types.FlatCuts")


_register_pytrees()


def sum_workers(n: int, term: Callable[[int], torch.Tensor]):
    """term(0) + ... + term(n-1), the reference's vmap-then-sum."""
    total = term(0)
    for j in range(1, n):
        total = total + term(j)
    return total
