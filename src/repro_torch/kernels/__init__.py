"""Hand-written CUDA kernels for the cut contraction.

csrc/cut_kernels.cu : the cut kernels (CUDA C++ for sm_90a)
csrc/inner_round.cu : the fused level-2 round kernel
build.py            : nvcc build on first use, ctypes binding
cut_eval.py         : cut wrappers, launch counters and plain versions
inner_round.py      : the fused round's wrapper and plain version
cut_ad.py           : MV/VM/OUTER autograd Functions (any-order AD)
ops.py              : `cut_eval` and `fused_cut_round`, the routing
                      points, and the FusedRound autograd Function
"""
