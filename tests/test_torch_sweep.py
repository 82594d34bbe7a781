"""The port's sweep engine (`core.engine.run_swept`, `RunSpec(engine=
"sweep")`) and the paper's scripts on it, on the CPU.

Inside the port (tests/test_engine.py:221-340 on the port): row r of a
sweep against `run_scanned` on schedule r at rtol 2e-5 / atol 1e-6 on
states and 2e-4 on `gap_sq`, cut counts exact (the reference's own
sweep-vs-scan tolerances: the vmapped body batches every contraction,
which may reorder f32 sums), swept hypers against scans with that
hyper, rejected inputs, the `RunSpec` dispatch and `host_time`
proration, and caller states and data left untouched.  Each runs on
the plain route and, with `ops.route` sent to "kernel", through the
`cut_ad` Functions and `FusedRound`, whose vmap rules batch every cut
contraction (their forward runs the plain version on the CPU).

Against the reference: `run_swept` on `make_quadratic_problem`, and
Fig. 1 (diabetes robust HPO), Fig. 2 and Table 2 on `engine="sweep"`
against the reference's swept scripts at the iteration budgets of
tests/test_torch_experiments.py, histories within ROADMAP's 1e-4 (Fig.
2 with atol 1e-6, as there), cut counts, sim_time and staleness
exact.  functorch's per-run fallback warning is an error here.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
# the reference's scripts live at the repo root, outside its package
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import conftest_shim as ref_shim  # noqa: E402
from benchmarks import fig1_robust_hpo as ref_fig1  # noqa: E402
from benchmarks import fig2_domain_adapt as ref_fig2  # noqa: E402
from benchmarks import table2_baselines as ref_table2  # noqa: E402
from conftest import (make_hyper, make_quadratic_problem,  # noqa: E402
                      make_schedules)
from repro.apps import domain_adaptation as jax_da  # noqa: E402
from repro.apps import robust_hpo as jax_hpo  # noqa: E402
from repro.core import run_swept as jax_run_swept  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import robust_hpo  # noqa: E402
from repro_torch.core import (RunSpec, Schedule,  # noqa: E402
                              StragglerConfig, SweepResult, afto, run,
                              run_scanned, run_swept, runner)
from repro_torch.experiments import common  # noqa: E402
from repro_torch.experiments import (fig1_robust_hpo,  # noqa: E402
                                     fig2_domain_adapt, table2_baselines)
from repro_torch.kernels import ops  # noqa: E402
from test_torch_core import port_hyper, quad_problems  # noqa: E402

STATE = dict(rtol=2e-5, atol=1e-6)
GAP = dict(rtol=2e-4, atol=1e-6)
HIST = dict(rtol=1e-4, atol=0.0)

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")


@pytest.fixture(autouse=True)
def fallback_warns():
    """functorch warns when an op has no batching rule and it loops over
    the runs instead; the mark above makes that warning an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.fixture(params=["plain", "functions"])
def route(request, monkeypatch):
    """The plain route, or every cut contraction and fused round through
    the autograd Functions (the card's route, on CPU tensors)."""
    if request.param == "functions":
        monkeypatch.setattr(ops, "route", lambda a, impl: "kernel")
    return request.param


def _schedules(n, seeds, **kw):
    return [Schedule(active=s.active, sim_time=s.sim_time,
                     max_staleness=s.max_staleness)
            for s in make_schedules(n, seeds, **kw)]


def _leaves(x):
    return torch.utils._pytree.tree_leaves(x)


def _stack(trees):
    return torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


def _assert_row(row, single, keys=("gap_sq",)):
    for a, b in zip(_leaves(single.state), _leaves(row.state)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   **STATE)
    for k in keys:
        np.testing.assert_allclose(row.history[k], single.history[k], **GAP,
                                   err_msg=k)
    for k in ("t", "sim_time", "max_staleness", "n_cuts_i", "n_cuts_ii"):
        assert list(row.history[k]) == list(single.history[k]), k


def _metrics(state):
    return {"z1_sq": torch.sum(state.z1 ** 2)}


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_swept_matches_looped_scanned(route, fused):
    _, tp = quad_problems()
    hyper = port_hyper(use_fused_inner=fused)
    scheds = _schedules(25, (0, 1, 2))
    swept = run_swept(tp, hyper, scheds, metrics_fn=_metrics,
                      metrics_every=10)
    assert isinstance(swept, SweepResult) and swept.n_runs == 3
    assert swept.history["gap_sq"].shape == (3, 3)
    assert swept.history["t"].shape == (3,)
    for r in range(3):
        single = run_scanned(tp, hyper, scheds[r], metrics_fn=_metrics,
                             metrics_every=10)
        _assert_row(swept.run(r), single, ("gap_sq", "z1_sq"))


@pytest.mark.parametrize("name,values", [
    ("eta_x", (0.05, 0.02)), ("eta_z", (0.05, 0.01)),
    ("s_active", (3, 4)), ("alpha4", (100.0, 0.25))])
def test_swept_hyper_matches_scanned(name, values):
    """Each run's hyper value rides its step (alpha4 bounds lam: a 0-d
    tensor in the clamp)."""
    _, tp = quad_problems()
    hyper = port_hyper()
    scheds = _schedules(20, (0, 0))
    swept = run_swept(tp, hyper, scheds, metrics_every=10,
                      sweep_hypers={name: list(values)})
    for r, value in enumerate(values):
        single = run_scanned(tp, dataclasses.replace(hyper, **{name: value}),
                             scheds[r], metrics_every=10)
        _assert_row(swept.run(r), single)


def test_swept_refresh_predicate_per_run(route):
    """t_pre swept: each run refreshes on its own iterations (the
    refresh runs for every run and each keeps its own branch)."""
    _, tp = quad_problems()
    hyper = port_hyper()
    scheds = _schedules(16, (0, 1))
    swept = run_swept(tp, hyper, scheds, metrics_every=4,
                      sweep_hypers={"t_pre": [5, 3]})
    for r, t_pre in enumerate((5, 3)):
        single = run_scanned(tp, dataclasses.replace(hyper, t_pre=t_pre),
                             scheds[r], metrics_every=4)
        _assert_row(swept.run(r), single)


@pytest.mark.parametrize("kw,match", [
    (dict(schedules=[]), "at least one"),
    (dict(schedules="mismatch"), "n_iterations"),
    (dict(sweep_hypers={"nope": [1, 2]}), "unknown"),
    (dict(sweep_hypers={"p_max": [4, 8]}), "shape-determining"),
    (dict(sweep_hypers={"use_fused_inner": [0, 1]}), "not a number"),
    (dict(sweep_hypers={"eta_z": [0.1]}), "shape"),
    (dict(sweep_hypers={"rho2": [0.5, 1.0]}, fused=True), "fused round"),
    (dict(data={"A": np.zeros((3, 4, 3, 3))}), "leading"),
    (dict(data={"A": object()}), "tensors or arrays"),
])
def test_swept_rejects_bad_inputs(kw, match):
    _, tp = quad_problems()
    hyper = port_hyper(use_fused_inner=kw.pop("fused", False))
    scheds = _schedules(6, (0, 1))
    if kw.get("schedules") == "mismatch":
        kw["schedules"] = [scheds[0], _schedules(8, (1,))[0]]
    kw.setdefault("schedules", scheds)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        run_swept(tp, hyper, **kw)


def test_run_engine_sweep_dispatch_and_host_time():
    """`RunSpec(engine="sweep", seeds=...)` seeds R schedules; the
    history carries per-run rows with the elapsed/R proration."""
    _, tp = quad_problems()
    spec = RunSpec(problem=tp, hyper=port_hyper(), n_iterations=20,
                   metrics_every=5, device="cpu",
                   scheduler=StragglerConfig(
                       n_workers=4, s_active=3, tau=5, n_stragglers=1,
                       seed=0))
    res = run(dataclasses.replace(spec, engine="sweep", seeds=(0, 1)))
    assert isinstance(res, SweepResult)
    assert res.history["gap_sq"].shape == (2, 4)
    assert res.history["host_time"].shape == (2, 4)
    np.testing.assert_allclose(res.history["host_time"][0],
                               res.history["host_time"][1])
    assert np.all(np.diff(res.history["host_time"][0]) > 0)
    single = run(spec)
    np.testing.assert_allclose(single.history["gap_sq"],
                               res.run(0).history["gap_sq"], **GAP)
    for bad in (dict(schedule=_schedules(20, (0,))[0]),
                dict(seeds=(0,), schedules=_schedules(20, (0,)))):
        with pytest.raises(ValueError):
            run(dataclasses.replace(spec, engine="sweep", **bad))
    with pytest.raises(ValueError, match="engine='sweep'"):
        run(dataclasses.replace(spec, seeds=(0, 1)))


def test_swept_respects_caller_states_and_data(route):
    """Stacked per-run initial states and per-run data: each row matches
    a scan with that run's state and data, and the caller's tensors are
    left as they were."""
    hyper = port_hyper()
    probs = [common.make_quadratic_problem(device="cpu", data={
        k: np.asarray(v) for k, v in make_quadratic_problem(seed=s)
        .data.items()}) for s in (0, 3)]
    scheds = _schedules(15, (0, 1))
    states = _stack([afto.init_state(p, hyper) for p in probs])
    data = _stack([p.data for p in probs])
    before = [x.clone() for x in _leaves((states, data))]
    swept = run(RunSpec(problem=probs[0], hyper=hyper, engine="sweep",
                        schedules=scheds, sweep_states=states, data=data,
                        metrics_every=5, device="cpu"))
    for r in range(2):
        single = run_scanned(probs[r], hyper, scheds[r], metrics_every=5)
        _assert_row(swept.run(r), single)
    for x, y in zip(before, _leaves((states, data))):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def test_run_swept_matches_reference_sweep():
    jp, tp = quad_problems()
    jscheds = make_schedules(30, (0, 1, 2))
    want = jax_run_swept(jp, make_hyper(), jscheds, metrics_every=10,
                         sweep_hypers={"eta_x": [0.05, 0.03, 0.05]})
    got = run_swept(tp, port_hyper(), _schedules(30, (0, 1, 2)),
                    metrics_every=10,
                    sweep_hypers={"eta_x": [0.05, 0.03, 0.05]})
    for k in ("gap_sq", "n_cuts_i", "n_cuts_ii", "sim_time",
              "max_staleness", "t"):
        w = np.asarray(want.history[k])
        if k.startswith("n_cuts") or k in ("sim_time", "max_staleness",
                                           "t"):
            np.testing.assert_array_equal(got.history[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got.history[k], w, **HIST,
                                       err_msg=k)
    for a, b in zip(_leaves(got.state.z1), jax.tree.leaves(want.state.z1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def _recording(monkeypatch, module):
    results, inner = [], module.run

    def recorded(spec):
        res = inner(spec)
        results.append(res)
        return res

    monkeypatch.setattr(module, "run", recorded)
    return results


def _ref_w0(dataset, seed=0):
    jt = jax_hpo.make_robust_hpo_problem(dataset, n_workers=4, seed=seed)
    return convert.to_torch(jax.tree.map(np.asarray, jt.problem.x3_init),
                            "cpu")


def _assert_rows_close(got, want, keys, **tol):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k in keys:
                np.testing.assert_allclose(g[k], np.asarray(w[k]), **tol,
                                           err_msg=k)
            else:
                assert g[k] == w[k], k


def _assert_sweeps_exact(got, want, n_runs):
    """One swept result a side, the counts and clocks equal row by row."""
    (g,), (w,) = got, want
    assert g.n_runs == w.n_runs == n_runs
    for k in ("n_cuts_i", "n_cuts_ii", "sim_time", "max_staleness"):
        np.testing.assert_array_equal(g.history[k],
                                      np.asarray(w.history[k]), err_msg=k)


def test_fig1_sweep_matches_reference_sweep(monkeypatch):
    """Fig. 1 on diabetes (robust HPO, AFTO and SFTO as one sweep, s_active
    swept), 20 iterations, the reference's w0."""
    want_runs = _recording(monkeypatch, ref_shim)
    want = ref_fig1.run_dataset("diabetes", n_iterations=20)
    got_runs = _recording(monkeypatch, runner)
    got = fig1_robust_hpo.run_dataset("diabetes", n_iterations=20,
                                      device="cpu", w0=_ref_w0("diabetes"))
    assert [r["algo"] for r in got] == ["AFTO"] * 2 + ["SFTO"] * 2
    _assert_rows_close(got, want, ("mse_clean", "mse_noisy", "gap_sq"),
                       **HIST)
    _assert_sweeps_exact(got_runs, want_runs, 2)


def test_fig2_sweep_matches_reference_sweep(monkeypatch):
    """Fig. 2, MNIST pretrain (N=4), 4 iterations, the reference's
    LeNets: both methods as one sweep through vmapped LeNet-5s."""
    jt = jax_da.make_domain_adaptation_problem(
        4, pretrain_domain="mnist", n_pretrain_per=24, n_finetune_per=12,
        seed=0)
    p = jt.problem
    x_init = [jax.tree.map(np.asarray, x)
              for x in (p.x1_init, p.x2_init, p.x3_init)]
    want_runs = _recording(monkeypatch, ref_shim)
    want = ref_fig2.run_direction("mnist_pretrain", 4)
    got_runs = _recording(monkeypatch, runner)
    got = fig2_domain_adapt.run_direction("mnist_pretrain", 4,
                                          device="cpu", x_init=x_init)
    _assert_rows_close(got, want, ("test_acc", "test_loss"), rtol=1e-4,
                       atol=1e-6)
    _assert_sweeps_exact(got_runs, want_runs, 2)
    np.testing.assert_allclose(got_runs[0].history["gap_sq"],
                               np.asarray(want_runs[0].history["gap_sq"]),
                               rtol=1e-4, atol=1e-6)


def test_table2_afto_sweep_matches_reference_sweep():
    """Table 2's AFTO seeds as one sweep on stacked per-seed data and
    initial states, against the reference's `run_afto_swept`, and
    against the port's own seeds run one after another."""
    seeds = (0, 1)
    jtasks = [jax_hpo.make_robust_hpo_problem("diabetes", n_workers=4,
                                              seed=s) for s in seeds]
    ttasks = [robust_hpo.make_robust_hpo_problem(
        "diabetes", n_workers=4, seed=s, device="cpu",
        w0=_ref_w0("diabetes", s)) for s in seeds]
    want = ref_table2.run_afto_swept(jtasks, 4, 12, seeds)
    got = table2_baselines.run_afto_swept(ttasks, 4, 12, seeds)
    serial = table2_baselines.run_afto_seeds(ttasks, 4, 12, seeds)
    assert len(got) == len(want) == 2
    for g, w, s in zip(got, want, serial):
        for k, v in w.items():
            np.testing.assert_allclose(g[k].numpy(), np.asarray(v),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(g[k].numpy(), s[k].numpy(),
                                       **STATE, err_msg=k)
    assert not np.allclose(got[0]["w0"].numpy(), got[1]["w0"].numpy())
