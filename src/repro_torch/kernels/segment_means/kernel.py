"""Segment-means kernel wrapper: builds ``csrc/segment_means.cu`` at first
use and launches it through ctypes.

The CUDA kernel replaces the TPU kernel
``repro/kernels/segment_means/kernel.py:segment_means_pallas`` and the
masked composition around it (``repro/kernels/dispatch.py:94-116``) with
one pass that reads x and the mask once; its source note says what bounds
it.  It is CUDA C++ rather than Triton so that every kernel of the port is
built the same way (one ``nvcc`` call of seconds, a plain C interface).

``segment_means`` takes its plain version for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises — it never falls back.  It
counts its launches in ``segment_means.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary
from repro_torch.kernels.segment_means.ref import segment_means_ref


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.segment_means_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "segment_means.cu", _bind)


def _check(x, L, mask):
    if x.ndim != 3:
        raise ValueError(f"segment_means: x {tuple(x.shape)} must be "
                         f"[B, N, D]")
    B, N, D = x.shape
    if L < 1 or N % L:
        raise ValueError(f"segment_means: N={N} does not split into L={L} "
                         f"equal segments")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"segment_means: dtype {x.dtype} not bf16/f32")
    if not x.is_contiguous():
        raise ValueError("segment_means: x must be contiguous")
    if mask is not None:
        if mask.device != x.device:
            raise ValueError(f"segment_means: mask on {mask.device}, x on "
                             f"{x.device}")
        if tuple(mask.shape) != (B, N) or mask.dtype != torch.bool:
            raise ValueError(f"segment_means: mask {tuple(mask.shape)} "
                             f"{mask.dtype} must be [B, N] bool")
        if not mask.is_contiguous():
            raise ValueError("segment_means: mask must be contiguous")


def segment_means(x: torch.Tensor,                   # [B, N, D]
                  L: int,
                  mask: Optional[torch.Tensor] = None  # [B, N] bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(means [B, L, D] in x's dtype, counts [B, L] f32) of L equal token
    segments, padded tokens (mask False) left out.

    CPU tensors take the plain version (``segment_means_ref``); CUDA
    tensors launch the kernel on the current stream."""
    if x.device.type == "cpu":
        return segment_means_ref(x, L, mask)
    if x.device.type != "cuda":
        raise ValueError(f"segment_means: no kernel for device {x.device}")
    _check(x, L, mask)
    B, N, D = x.shape
    out = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    counts = torch.empty((B, L), dtype=torch.float32, device=x.device)
    lib = LIBRARY.lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.segment_means_launch(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), counts.data_ptr(), B, N, D, L,
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"segment_means kernel launch failed: code {rc}")
    segment_means.launches += 1
    return out, counts


segment_means.launches = 0
