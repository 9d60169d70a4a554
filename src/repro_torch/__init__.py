"""`repro_torch` — the PyTorch/CUDA port of `repro` for NVIDIA Hopper.

Mirrors the JAX package's subpackages (`configs`, `core`, `kernels`,
`models`, `api`, ...).  It imports `torch` and numpy, never `jax` and
nothing of `repro`; the parity tests hold each module against its JAX
counterpart.  Entry points run on the CUDA card unless the caller asks for
the CPU (``device="cpu"``).
"""
