"""The dry-run's profile of one (arch x shape x mesh) step, traced on
meta tensors (no card).

Counterpart of `repro/launch/profile.py`, which reads XLA's optimized
module.  Prints, for the local program of one device (`launch.dryrun`):

  * the histogram of the aten ops it runs (what the program is made of;
    the hand-written kernels' meta branches appear under their routes'
    names),
  * the analytic collective schedule in order, each entry named by the
    layer and leaf that causes it (what the roofline's collective term
    sums; `launch.roofline.collective_schedule`),
  * the top-k largest allocations (where the memory term comes from).

  PYTHONPATH=src python -m repro_torch.launch.profile --arch llama3-8b \\
      --shape train_4k --mesh pod --top 15
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, get_shape
from repro_torch.fed.trilevel_llm import FedHyper
from repro_torch.launch import dryrun as dr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--step", default=None, choices=list(dr.STEP_KINDS))
    ap.add_argument("--route", default="kernel", choices=["kernel", "ref"])
    ap.add_argument("--cut-mode", default="exact",
                    choices=["exact", "sketch"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    mesh_name, mesh = dr.resolve_mesh(args.mesh)
    cfg = get_config(args.arch)
    shape = get_shape(args.shape)
    hyper = FedHyper(n_workers=dr._n_workers(mesh), cut_mode=args.cut_mode,
                     p_max=2, k_inner=1, remat=False)
    step_kind = args.step or dr.default_step_kind(shape)
    built, lcfg, _ = dr.build(cfg, shape, mesh, step_kind, hyper, args.route)
    _, _, counter = dr.trace(built, mesh, lcfg, top=args.top)
    schedule = dr.schedule_of(cfg, mesh, built, step_kind, shape, hyper)

    print(f"== op histogram ({args.arch} x {args.shape} x {mesh_name}, "
          f"{step_kind}, one device) ==")
    for op, n in counter.hist.most_common(20):
        print(f"  {op:>24s} {n}")
    print("\n== collectives (schedule order) ==")
    for c in schedule:
        print(f"  {c.kind:>12s} over {c.axis:<9s} {c.nbytes / 1e6:12.3f} MB"
              f" x {c.count:<5d} {c.where}: {c.leaf}")
    if not schedule:
        print("  none")
    print(f"\n== top-{args.top} largest tensors ==")
    for b, op, shp, dt in counter.largest():
        print(f"  {b / 1e9:8.3f} GB  {op:>18s}  {dt} {list(shp)}")


if __name__ == "__main__":
    main()
