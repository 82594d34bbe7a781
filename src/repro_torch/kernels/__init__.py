"""Hand-written CUDA kernels of the port.

csrc/cut_kernels.cu     : the cut kernels (CUDA C++ for sm_90a)
csrc/inner_round.cu     : the fused level-2 round kernel
csrc/flash_attention.cu : blockwise GQA attention forward
csrc/mlstm_chunk.cu     : one chunk of chunkwise mLSTM (two launches)
build.py                : nvcc build on first use, ctypes binding
cut_eval.py             : cut wrappers, launch counters and plain versions
inner_round.py          : the fused round's wrapper and plain version
flash_attention.py      : the attention kernel's wrapper
mlstm_chunk.py          : the mLSTM chunk kernel's wrapper
ref.py                  : plain versions of the two LLM kernels
cut_ad.py               : MV/VM/OUTER autograd Functions (any-order AD)
ops.py                  : the routing points of every kernel, and the
                          FusedRound autograd Function
"""
