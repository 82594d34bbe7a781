"""The port's paper evaluation (`repro_torch.experiments`) against the
reference's scripts (`benchmarks/`) on identical inputs, on the CPU.

Here the reference runs its methods and seeds on the scan engine (Fig.
1 and 2) or as one swept dispatch (Table 2, the rate and comm checks);
the port runs Fig. 1, Fig. 2 and Table 2 on its scan engine, one run
after another (`engine="scan"`), and the rate check as one sweep, its
default.  tests/test_torch_sweep.py holds the port's default sweeps to
the reference's swept scripts.  Simulated times
and cut counts must be equal, histories within rtol 1e-4 (Fig. 2 with
atol 1e-6, as tests/test_torch_fused.py's domain-adaptation trajectory),
Table 2's mean x3 within 1e-4, and what the scripts derive from equal
rows equal.
"""
import os
import subprocess
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

from benchmarks import comm_complexity as ref_comm  # noqa: E402
from benchmarks import conftest_shim as ref_shim  # noqa: E402
from benchmarks import fig1_robust_hpo as ref_fig1  # noqa: E402
from benchmarks import fig2_domain_adapt as ref_fig2  # noqa: E402
from benchmarks import rate_thm45 as ref_rate  # noqa: E402
from benchmarks import table2_baselines as ref_table2  # noqa: E402
from repro.apps import domain_adaptation as jax_da  # noqa: E402
from repro.apps import robust_hpo as jax_hpo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.apps import robust_hpo  # noqa: E402
from repro_torch.core import runner  # noqa: E402
from repro_torch.experiments import (comm_complexity, common,  # noqa: E402
                                     fig1_robust_hpo, fig2_domain_adapt,
                                     rate_thm45, table2_baselines)
from repro_torch.experiments import run as run_cli  # noqa: E402

HIST = dict(rtol=1e-4, atol=0.0)


def _recording(monkeypatch, module):
    """Record every result of `module.run` while the test runs."""
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


def _derived(rows):
    """The CSV rows' derived fields (the times differ)."""
    return [(name, derived) for name, _, derived in rows]


# ---------------------------------------------------------------------------
# Fig. 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fig1_rows():
    """The reference's and the port's diabetes rows (20 iterations, the
    reference's w0), and each side's run histories."""
    with pytest.MonkeyPatch.context() as mp:
        want_runs = _recording(mp, ref_fig1)
        want = ref_fig1.run_dataset("diabetes", n_iterations=20,
                                    engine="scan")
        got_runs = _recording(mp, runner)
        got = fig1_robust_hpo.run_dataset("diabetes", n_iterations=20,
                                          engine="scan", device="cpu",
                                          w0=_ref_w0("diabetes"))
    return got, want, got_runs, want_runs


def test_fig1_diabetes_matches_reference(fig1_rows):
    got, want, got_runs, want_runs = fig1_rows
    assert [r["algo"] for r in got] == ["AFTO"] * 2 + ["SFTO"] * 2
    _assert_rows_close(got, want, ("mse_clean", "mse_noisy", "gap_sq"),
                       **HIST)
    assert len(got_runs) == len(want_runs) == 2
    for g, w in zip(got_runs, want_runs):
        for k in ("n_cuts_i", "n_cuts_ii", "sim_time", "max_staleness"):
            assert list(g.history[k]) == list(np.asarray(w.history[k])), k


def test_fig1_main_derives_what_the_reference_derives(fig1_rows,
                                                      monkeypatch):
    rows = fig1_rows[0]
    monkeypatch.setattr(ref_fig1, "run_dataset", lambda *a, **k: rows)
    monkeypatch.setattr(fig1_robust_hpo, "run_dataset",
                        lambda *a, **k: rows)
    want = ref_fig1.main(n_iterations=20, datasets=("diabetes",),
                         engine="scan")
    got = fig1_robust_hpo.main(n_iterations=20, datasets=("diabetes",),
                               device="cpu")
    assert _derived(got) == _derived(want)


def _speedup_rows(afto, sfto):
    rows = []
    for algo, noisy in (("AFTO", afto), ("SFTO", sfto)):
        for i, m in enumerate(noisy):
            rows.append({"dataset": "boston", "algo": algo, "iter": i,
                         "sim_time": (i + 1) * (1.5 if algo == "SFTO"
                                                else 1.0),
                         "mse_noisy": m})
    return rows


@pytest.mark.parametrize("afto,sfto", [
    ([1.0, 0.8, 0.6, 0.5], [1.0, 0.9, 0.8, 0.65]),   # both reach 0.7x
    ([1.0, 0.8, 0.75, 0.72], [1.0, 0.6, 0.5, 0.4]),  # AFTO never does
    ([1.0, 0.5, 0.4, 0.3], [1.0, 0.9, 0.85, 0.8]),   # SFTO never does
    ([2.0, 1.0, 0.5, 0.2], [2.0, 1.4, 1.39, 1.0]),   # SFTO hits on a tie
])
def test_speedup_matches_reference(afto, sfto):
    rows = _speedup_rows(afto, sfto)
    want = ref_fig1.speedup(rows, "boston")
    got = fig1_robust_hpo.speedup(rows, "boston")
    assert got == want or (np.isnan(got) and np.isnan(want))


def test_speedup_on_the_fig1_rows(fig1_rows):
    got, want = fig1_rows[:2]
    for frac in (0.7, 0.95, 0.999):
        a = fig1_robust_hpo.speedup(got, "diabetes", frac)
        b = ref_fig1.speedup(want, "diabetes", frac)
        assert a == b or (np.isnan(a) and np.isnan(b))


# ---------------------------------------------------------------------------
# Fig. 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fig2_rows():
    """MNIST-pretrain (N=4), 4 iterations, the reference's LeNets."""
    jt = jax_da.make_domain_adaptation_problem(
        4, pretrain_domain="mnist", n_pretrain_per=24, n_finetune_per=12,
        seed=0)
    p = jt.problem
    x_init = [jax.tree.map(np.asarray, x)
              for x in (p.x1_init, p.x2_init, p.x3_init)]
    with pytest.MonkeyPatch.context() as mp:
        want_runs = _recording(mp, ref_fig2)
        want = ref_fig2.run_direction("mnist_pretrain", 4, engine="scan")
        got_runs = _recording(mp, runner)
        got = fig2_domain_adapt.run_direction("mnist_pretrain", 4,
                                              engine="scan", device="cpu",
                                              x_init=x_init)
    return got, want, got_runs, want_runs


def test_fig2_mnist_pretrain_matches_reference(fig2_rows):
    got, want, got_runs, want_runs = fig2_rows
    _assert_rows_close(got, want, ("test_acc", "test_loss"), rtol=1e-4,
                       atol=1e-6)
    assert len(got_runs) == len(want_runs) == 2
    for g, w in zip(got_runs, want_runs):
        np.testing.assert_allclose(g.history["gap_sq"],
                                   np.asarray(w.history["gap_sq"]),
                                   rtol=1e-4, atol=1e-6)
        for k in ("n_cuts_i", "n_cuts_ii"):
            assert list(g.history[k]) == list(np.asarray(w.history[k])), k


@pytest.mark.parametrize("shift", [0.0, 0.05])
def test_fig2_main_derives_what_the_reference_derives(fig2_rows,
                                                      monkeypatch, shift):
    """The accel-to-worst-final-loss rule on the port's rows, and on
    rows where SFTO ends worse."""
    rows = [dict(r, test_loss=r["test_loss"] + (shift if r["algo"] ==
                                                "SFTO" else 0.0))
            for r in fig2_rows[0]]
    monkeypatch.setattr(ref_fig2, "run_direction", lambda *a, **k: rows)
    monkeypatch.setattr(fig2_domain_adapt, "run_direction",
                        lambda *a, **k: rows)
    want = ref_fig2.main(4, directions=("mnist_pretrain",), engine="scan")
    got = fig2_domain_adapt.main(4, directions=("mnist_pretrain",),
                                 device="cpu")
    assert _derived(got) == _derived(want)


# ---------------------------------------------------------------------------
# Table 2
# ---------------------------------------------------------------------------

def test_table2_afto_seeds_match_the_reference_sweep():
    seeds = (0, 1)
    jtasks = [jax_hpo.make_robust_hpo_problem("diabetes", n_workers=4,
                                              seed=s) for s in seeds]
    ttasks = [robust_hpo.make_robust_hpo_problem(
        "diabetes", n_workers=4, seed=s, device="cpu", w0=_ref_w0(
            "diabetes", s)) for s in seeds]
    want = ref_table2.run_afto_swept(jtasks, 4, 12, seeds)
    got = table2_baselines.run_afto_seeds(ttasks, 4, 12, seeds)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k, v in w.items():
            np.testing.assert_allclose(g[k].numpy(), np.asarray(v),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
    assert not np.allclose(got[0]["w0"].numpy(), got[1]["w0"].numpy())


def test_table2_main_scores_every_method():
    (name, us, derived), = table2_baselines.main(
        n_iterations=2, seeds=(0,), datasets=("diabetes",), device="cpu")
    assert name == "table2_diabetes" and us > 0
    fields = dict(f.split("=") for f in derived.split(";"))
    assert set(fields) == {"afto", "adbo", "fednest", "best"}
    assert fields["best"] in ("AFTO", "ADBO", "FEDNEST")
    for k in ("afto", "adbo", "fednest"):
        mean, std = (float(x) for x in fields[k].split("+-"))
        assert np.isfinite(mean) and mean > 0 and std == 0.0


# ---------------------------------------------------------------------------
# Thm 4.5 and Thm 4.6
# ---------------------------------------------------------------------------

def _gap_trajectory(seed, n=80, t_max=400):
    rng = np.random.default_rng(seed)
    t = np.arange(5, t_max + 1, t_max // n, dtype=np.float64)
    g = 20.0 / t ** rng.uniform(0.3, 1.5) * np.exp(
        rng.normal(scale=0.3, size=t.shape))
    return t, g


@pytest.mark.parametrize("seed,t1", [(0, 200), (1, 200), (2, 100),
                                     (3, 390), (4, 0)])
def test_fit_slope_matches_reference(seed, t1):
    t, g = _gap_trajectory(seed)
    got, gmin = rate_thm45._fit_slope(t, g, t1)
    want, wmin = ref_rate._fit_slope(t, g, t1)
    assert got == want or (np.isnan(got) and np.isnan(want))
    np.testing.assert_array_equal(gmin, wmin)


def test_fit_slope_flat_tail_is_nan():
    t = np.arange(5.0, 105.0, 5.0)
    g = np.ones_like(t)
    got, _ = rate_thm45._fit_slope(t, g, 50)
    want, _ = ref_rate._fit_slope(t, g, 50)
    assert np.isnan(got) and np.isnan(want)


@pytest.fixture(scope="module")
def quad_data():
    """The reference's quadratic problem data (`jax.random` draws)."""
    data = ref_shim.make_quadratic_problem(n_workers=4, dim=3, seed=0).data
    return {k: np.asarray(v) for k, v in data.items()}


def test_rate_main_matches_reference(quad_data):
    with pytest.MonkeyPatch.context() as mp:
        want_runs = _recording(mp, ref_rate)
        want = ref_rate.main(n_iterations=150)
        got_runs = _recording(mp, runner)
        got = rate_thm45.main(n_iterations=150, device="cpu",
                              data=quad_data)
    assert _derived(got) == _derived(want)
    sweep, = want_runs
    got_sweep, = got_runs
    assert got_sweep.n_runs == 2
    for r in range(2):
        g, w = got_sweep.run(r).history, sweep.run(r).history
        np.testing.assert_allclose(g["gap_sq"], np.asarray(w["gap_sq"]),
                                   rtol=1e-4, atol=1e-5)
        for k in ("sim_time", "n_cuts_i", "n_cuts_ii"):
            assert list(g[k]) == list(np.asarray(w[k])), k


def test_comm_main_matches_reference(quad_data):
    want = ref_comm.main()
    got = comm_complexity.main(device="cpu", data=quad_data)
    assert _derived(got) == _derived(want)


def test_quadratic_problem_draws_from_a_generator():
    a = common.make_quadratic_problem(seed=3, device="cpu")
    b = common.make_quadratic_problem(seed=3, device="cpu")
    c = common.make_quadratic_problem(seed=4, device="cpu")
    assert a.data["A"].shape == (4, 3, 3) and a.data["b"].shape == (4, 3)
    assert torch.equal(a.data["A"], b.data["A"])
    assert not torch.equal(a.data["A"], c.data["A"])


# ---------------------------------------------------------------------------
# the command line, devices and what is not ported yet
# ---------------------------------------------------------------------------

def test_cli_runs_the_comm_suite_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.run", "--fast",
         "--only", "comm", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 2 and lines[1].startswith("comm_complexity_thm46,")
    assert "C1_bits=" in lines[1] and "ratio=" in lines[1]


def test_cli_refuses_an_unknown_suite():
    with pytest.raises(SystemExit):
        run_cli.main(["--only", "engine", "--device", "cpu"])


ENTRY_POINTS = {
    "fig1": lambda: fig1_robust_hpo.run_dataset("diabetes", 1),
    "fig2": lambda: fig2_domain_adapt.run_direction("mnist_pretrain", 1),
    "table2": lambda: table2_baselines.main(1, seeds=(0,),
                                            datasets=("diabetes",)),
    "rate": lambda: rate_thm45.main(1, n_seeds=1),
    "comm": lambda: comm_complexity.main(1),
    "quadratic": lambda: common.make_quadratic_problem(),
    "cli": lambda: run_cli.main(["--only", "comm"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_cuda_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
