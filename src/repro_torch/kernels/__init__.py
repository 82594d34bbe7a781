"""Hand-written CUDA kernels for the cut contraction.

csrc/cut_kernels.cu : the kernels (CUDA C++ for sm_90a)
build.py            : nvcc build on first use, ctypes binding
cut_eval.py         : wrappers, launch counters and plain versions
cut_ad.py           : MV/VM/OUTER autograd Functions (any-order AD)
ops.py              : `cut_eval`, the routing point
"""
