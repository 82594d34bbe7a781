"""The dry-run's per-device count of Llama-3 8B's cut refresh at full
depth (32 layers, bf16) on a 1 x 1 mesh and with the workers split over
a ("data", 2) worker mesh, as `launch.train --mesh-workers 2` splits
them: N 2, per-worker batch 1, sequence 129, sketch r 4096, p_max 2,
k_inner 1 (`chip_smoke.py` phase 16 (b)'s AFTO settings).  Meta tensors
only: no card, about half a minute a mesh on one CPU core.

    PYTHONPATH=src python benchmarks/torch_llama_refresh_mesh_count.py
"""
import json

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.fed.trilevel_llm import FedHyper
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh


def main() -> None:
    torch.set_num_threads(1)
    hyper = FedHyper(n_workers=2, cut_mode="sketch", sketch_r=4096, p_max=2,
                     k_inner=1, remat=False, eta_x=1e-5, eta_z=1e-5)
    for data in (1, 2):
        row = dryrun.run_one(
            get_config("llama3-8b"), InputShape("llama", 129, 2, "train"),
            AbstractMesh(("data", "model"), (data, 1)), step="cut_refresh",
            route="ref", hyper=hyper, verbose=False)
        print(json.dumps({
            "mesh": f"data {data}", "status": row["status"],
            "arg_gib": round(row["arg_bytes"] / 2 ** 30, 2),
            "temp_gib": round(row["temp_bytes"] / 2 ** 30, 2),
            "trace_s": row["trace_s"]}))


if __name__ == "__main__":
    main()
