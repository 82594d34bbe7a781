"""The paper's evaluation on the port (counterparts of the reference's
`benchmarks/` scripts, kept inside the package because those scripts
import jax):

common.py           the per-method run loop and the quadratic problem
fig1_robust_hpo.py  Fig. 1: robust HPO, AFTO vs SFTO, four datasets
fig2_domain_adapt.py  Fig. 2: domain adaptation, both pretrain directions
table2_baselines.py Table 2: AFTO vs ADBO vs FedNest, noisy-test MSE
rate_thm45.py       Thm. 4.5: the O(1/eps^2) iteration-complexity check
comm_complexity.py  Thm. 4.6: bits per master iteration vs C1
engine_speed.py     the sweep engine against a loop of single runs
run.py              `python -m repro_torch.experiments.run`: the CSV

Each entry point takes `device=None`, which means the CUDA device (and
raises without one); `device="cpu"` runs on the CPU.  As in the
reference, the methods of a figure, Table 2's AFTO seeds and the rate
check's seeds run as one sweep (`engine="sweep"`, the default);
`engine="scan"` runs them one after another.
"""
