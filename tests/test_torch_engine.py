"""The port's engines and entry points against the reference, plus the
port's independence from jax and its device rules, on the CPU.

Trajectory parity holds the port to state 1e-4/1e-5 and gap 1e-4/1e-5
with cut counts exact.  That is looser than the reference's own
scan-vs-eager 1e-5/1e-6 state tolerance (tests/test_engine.py:92-115):
across frameworks the reductions run in different orders, and 40
iterations of second-order refreshes carry those last-bit differences
forward.
"""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_hyper, make_straggler_cfg
from repro.apps import robust_hpo as jax_hpo
from repro.core import RunSpec as JaxRunSpec
from repro.core import StragglerConfig as JaxStragglerConfig
from repro.core import StragglerScheduler as JaxScheduler
from repro.core import run as jax_run
from repro_torch import convert
from repro_torch.apps import robust_hpo
from repro_torch.core import (RunSpec, Schedule, StragglerConfig, run,
                              run_scanned)
from repro_torch.kernels import cut_eval as kern
from test_torch_core import assert_states_close, port_hyper, quad_problems

REPO = Path(__file__).resolve().parents[1]
TRAJ = dict(rtol=1e-4, atol=1e-5)


def _port_schedule(schedule):
    return Schedule(active=schedule.active, sim_time=schedule.sim_time,
                    max_staleness=schedule.max_staleness)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

def test_quickstart_trajectory_matches_reference():
    jp, tp = quad_problems()
    schedule = JaxScheduler(make_straggler_cfg()).precompute(40)
    want = jax_run(JaxRunSpec(problem=jp, hyper=make_hyper(),
                              schedule=schedule, metrics_every=10))
    got = run_scanned(tp, port_hyper(), _port_schedule(schedule),
                      metrics_every=10)
    assert_states_close(got.state, want.state, **TRAJ)
    h, hw = got.history, want.history
    for k in ("t", "sim_time", "max_staleness"):
        np.testing.assert_array_equal(h[k], np.asarray(hw[k]))
    np.testing.assert_allclose(h["gap_sq"], np.asarray(hw["gap_sq"]),
                               **TRAJ)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(h[k]) == list(np.asarray(hw[k]))


def test_eager_engine_matches_scan_engine():
    _, tp = quad_problems()
    cfg = StragglerConfig(n_workers=4, s_active=3, tau=5, n_stragglers=1,
                          seed=1)
    spec = RunSpec(problem=tp, hyper=port_hyper(), scheduler=cfg,
                   n_iterations=25, metrics_every=10, device="cpu",
                   metrics_fn=lambda s: {"z1_sq": torch.sum(s.z1 ** 2)})
    scan = run(spec)
    eager = run(dataclasses.replace(spec, engine="eager"))
    assert_states_close(scan.state, convert.to_numpy(eager.state),
                        rtol=1e-6, atol=1e-7)
    for k in ("t", "sim_time", "max_staleness", "n_cuts_i", "n_cuts_ii"):
        assert list(scan.history[k]) == list(eager.history[k])
    for k in ("gap_sq", "z1_sq"):
        np.testing.assert_allclose(scan.history[k], eager.history[k],
                                   rtol=1e-6, atol=1e-7)


def _hpo_metrics(task, mean):
    def metrics(state):
        w = mean(state.X3)
        return {"mse_clean": task.test_mse(w, 0.0),
                "mse_noisy": task.test_mse(w, 0.3, seed=0)}
    return metrics


def test_robust_hpo_diabetes_trajectory_matches_reference():
    """N=4, t_pre=5, 20 iterations, the reference's jax.random w0 carried
    over: identical data arrays; gap and test-MSE histories within 1e-4."""
    n = 4
    jt = jax_hpo.make_robust_hpo_problem("diabetes", n_workers=n, seed=0)
    w0 = convert.to_torch(jax.tree.map(np.asarray, jt.problem.x3_init),
                          "cpu")
    tt = robust_hpo.make_robust_hpo_problem("diabetes", n_workers=n, seed=0,
                                            device="cpu", w0=w0)
    for k, v in tt.problem.data.items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray(jt.problem.data[k]).astype(v.numpy().dtype))
    cfg = dict(n_workers=n, s_active=3, tau=10, n_stragglers=1, seed=0)
    want = jax_run(JaxRunSpec(
        problem=jt.problem, hyper=jax_hpo.default_hyper(jt, n, 3, 10,
                                                        t_pre=5),
        scheduler=JaxStragglerConfig(**cfg), n_iterations=20,
        metrics_every=5,
        metrics_fn=_hpo_metrics(
            jt, lambda X3: jax.tree.map(lambda x: jnp.mean(x, 0), X3))))
    got = run(RunSpec(
        problem=tt.problem, hyper=robust_hpo.default_hyper(tt, n, 3, 10,
                                                           t_pre=5),
        scheduler=StragglerConfig(**cfg), n_iterations=20, metrics_every=5,
        device="cpu",
        metrics_fn=_hpo_metrics(
            tt, lambda X3: {k: v.mean(0) for k, v in X3.items()})))
    for k in ("gap_sq", "mse_clean", "mse_noisy"):
        np.testing.assert_allclose(got.history[k],
                                   np.asarray(want.history[k]),
                                   rtol=1e-4, atol=0, err_msg=k)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(got.history[k]) == list(np.asarray(want.history[k]))


# ---------------------------------------------------------------------------
# routes, devices and what is not ported yet
# ---------------------------------------------------------------------------

def test_cpu_route_launches_no_kernel_over_a_run():
    _, tp = quad_problems()
    kern.reset_launches()
    run(RunSpec(problem=tp, hyper=port_hyper(), n_iterations=10,
                metrics_every=5, device="cpu"))
    assert sum(kern.LAUNCHES.values()) == 0


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        robust_hpo.make_robust_hpo_problem("diabetes", n_workers=4)
    _, tp = quad_problems()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(RunSpec(problem=tp, hyper=port_hyper(), n_iterations=2))


@pytest.mark.parametrize("change,exc", [
    (dict(transport=object()), ValueError),
    (dict(engine="warp"), ValueError),
    (dict(mesh=object()), NotImplementedError),
    (dict(chunk_hook=lambda state, t: None), ValueError),
    (dict(chunk_size=5, engine="sweep"), ValueError),
])
def test_unported_run_options_raise(change, exc):
    _, tp = quad_problems()
    spec = RunSpec(problem=tp, hyper=port_hyper(), n_iterations=2,
                   device="cpu")
    with pytest.raises(exc):
        run(dataclasses.replace(spec, **change))


# ---------------------------------------------------------------------------
# independence from jax and from the reference package
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
                (path, mod)


def test_port_runs_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['benchmarks'] = None\n"
        "import torch\n"
        "from repro_torch.core import Hyper, RunSpec, TrilevelProblem, run\n"
        "import repro_torch.apps.robust_hpo, repro_torch.convert\n"
        "import repro_torch.apps.baselines, repro_torch.experiments.run\n"
        "import repro_torch.checkpoint, repro_torch.data\n"
        "import repro_torch.fed.runtime, repro_torch.launch.serve\n"
        "g = torch.Generator().manual_seed(0)\n"
        "data = {'A': torch.randn(4, 3, 3, generator=g) * 0.3,\n"
        "        'b': torch.randn(4, 3, generator=g)}\n"
        "f1 = lambda d, x1, x2, x3: torch.sum(\n"
        "    (x1 - d['A'] @ x3 - d['b']) ** 2)\n"
        "f2 = lambda d, x1, x2, x3: torch.sum((x2 + x3) ** 2)\n"
        "f3 = lambda d, x1, x2, x3: torch.sum((x3 - x1) ** 2)\n"
        "p = TrilevelProblem(f1=f1, f2=f2, f3=f3, data=data, n_workers=4,\n"
        "    x1_init=torch.zeros(3), x2_init=torch.zeros(3),\n"
        "    x3_init=torch.zeros(3))\n"
        "h = Hyper(n_workers=4, s_active=3, tau=5, k_inner=3, p_max=6,\n"
        "          t_pre=5, t1=100, d1=3)\n"
        "r = run(RunSpec(problem=p, hyper=h, n_iterations=20,\n"
        "                metrics_every=10, device='cpu'))\n"
        "g = r.history['gap_sq']\n"
        "assert g[-1] < g[0], g\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
        "                     if sys.modules[m] is not None]\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "cuda" in out.stderr.lower()
