"""PyTorch / CUDA port of the federated trilevel (AFTO) package.

Mirrors `repro`'s module layout (`core`, `kernels`, `data`, `models`,
`apps`, `utils`) so each counterpart is easy to find.  The port imports
torch and numpy only; the cut contractions run in hand-written CUDA
kernels (`repro_torch.kernels`) on a CUDA device and in their plain
PyTorch versions on the CPU.
"""
