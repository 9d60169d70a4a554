"""PRISM attention kernel wrapper: builds ``csrc/prism_attention.cu`` at
first use and launches it through ctypes.

The CUDA kernel replaces the TPU kernel
``repro/kernels/prism_attention/kernel.py:prism_attention_pallas``; its
source note says what bounds it and how it is laid out.  Unlike the Pallas
kernel it takes a mask on the local keys, any Nq and Nk, and a query
offset, so the padded ViT exchange runs on it.

``prism_attention`` takes its plain version for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises — it never falls back.  It
counts its launches in ``prism_attention.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.nvcc import CudaLibrary
from repro_torch.kernels.prism_attention.ref import prism_attention_ref

HEAD_DIMS = (64, 128)
ROWS = 32                          # R in the CUDA source: G may not exceed it


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.prism_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "prism_attention.cu", _bind)


def _check(q, k, v, km, vm, bias, kv_mask):
    dev = q.device
    named = (("q", q), ("k_loc", k), ("v_loc", v), ("k_means", km),
             ("v_means", vm), ("mean_bias", bias))
    if kv_mask is not None:
        named += (("kv_mask", kv_mask),)
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"prism_attention: {name} on {t.device}, q on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"prism_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"prism_attention: {name} must be 16-byte "
                             f"aligned")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or km.ndim != 4 \
            or vm.shape != km.shape:
        raise ValueError(f"prism_attention: q {tuple(q.shape)} must be "
                         f"[B,Nq,H,dh], k/v {tuple(k.shape)} [B,Nk,Hk,dh], "
                         f"means {tuple(km.shape)} [B,M,Hk,dh]")
    B, Nq, H, dh = q.shape
    _, Nk, Hk, _ = k.shape
    M = km.shape[1]
    if (k.shape[0] != B or k.shape[3] != dh or km.shape[0] != B
            or km.shape[2:] != k.shape[2:] or tuple(bias.shape) != (B, M)):
        raise ValueError(f"prism_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, means {tuple(km.shape)}, bias "
                         f"{tuple(bias.shape)} disagree")
    if kv_mask is not None and (tuple(kv_mask.shape) != (B, Nk)
                                or kv_mask.dtype != torch.bool):
        raise ValueError(f"prism_attention: kv_mask {tuple(kv_mask.shape)} "
                         f"{kv_mask.dtype} must be [B, Nk] bool")
    if dh not in HEAD_DIMS:
        raise ValueError(f"prism_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if Nk < 1 or H % Hk or H // Hk > ROWS:
        raise ValueError(f"prism_attention: Nk={Nk}, H={H}, Hk={Hk} "
                         f"unsupported (H a multiple of Hk, at most "
                         f"{ROWS}x)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"prism_attention: dtype {q.dtype} not bf16/f32")
    for name, t in named[1:5]:
        if t.dtype != q.dtype:
            raise TypeError(f"prism_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"prism_attention: mean_bias must be f32, got "
                        f"{bias.dtype}")


def prism_attention(q: torch.Tensor,          # [B, Nq, H, dh]
                    k_loc: torch.Tensor,      # [B, Nk, Hk, dh]
                    v_loc: torch.Tensor,
                    k_means: torch.Tensor,    # [B, M, Hk, dh]
                    v_means: torch.Tensor,
                    mean_bias: torch.Tensor,  # [B, M] f32
                    *, causal: bool = True,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None,  # [B, Nk] bool
                    q_offset: int = 0,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Softmax attention of q over [local K/V ‖ mean K/V + bias] →
    [B, Nq, H, dh] in ``out_dtype`` (q's dtype by default; float32 gives
    the result before its rounding to bf16, for checks).

    CPU tensors take the plain version (``prism_attention_ref``); CUDA
    tensors launch the kernel on the current stream."""
    if q.device.type == "cpu":
        return prism_attention_ref(q, k_loc, v_loc, k_means, v_means,
                                   mean_bias, causal=causal, scale=scale,
                                   logit_softcap=softcap, kv_mask=kv_mask,
                                   q_offset=q_offset, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"prism_attention: no kernel for device {q.device}")
    _check(q, k_loc, v_loc, k_means, v_means, mean_bias, kv_mask)
    B, Nq, H, dh = q.shape
    Nk, Hk, M = k_loc.shape[1], k_loc.shape[2], k_means.shape[1]
    scale = (dh ** -0.5) if scale is None else scale
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"prism_attention: out_dtype {out_dtype} not "
                        f"{q.dtype} or float32")
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lib = LIBRARY.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.prism_attention_launch(
            q.data_ptr(), k_loc.data_ptr(), v_loc.data_ptr(),
            k_means.data_ptr(), v_means.data_ptr(), mean_bias.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            B, Nq, Nk, M, H, Hk, dh, int(q.dtype == torch.bfloat16),
            int(out_dtype == torch.float32), int(causal), int(q_offset),
            float(scale), float(softcap or 0.0),
            stream)
    if rc != 0:
        raise RuntimeError(f"prism_attention kernel launch failed: code {rc}")
    prism_attention.launches += 1
    return out


prism_attention.launches = 0
