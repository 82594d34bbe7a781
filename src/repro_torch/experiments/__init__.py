"""The paper's evaluation on the port (counterparts of the reference's
`benchmarks/` scripts, kept inside the package because those scripts
import jax):

common.py           the per-method run loop and the quadratic problem
fig1_robust_hpo.py  Fig. 1: robust HPO, AFTO vs SFTO, four datasets
fig2_domain_adapt.py  Fig. 2: domain adaptation, both pretrain directions
table2_baselines.py Table 2: AFTO vs ADBO vs FedNest, noisy-test MSE
rate_thm45.py       Thm. 4.5: the O(1/eps^2) iteration-complexity check
comm_complexity.py  Thm. 4.6: bits per master iteration vs C1
run.py              `python -m repro_torch.experiments.run`: the CSV

Each entry point takes `device=None`, which means the CUDA device (and
raises without one); `device="cpu"` runs on the CPU.  Every method and
seed runs on the scan engine, one after another: the sweep engine is not
ported yet (ROADMAP.md Queue 1, item 3).
"""
