"""PRISM attention kernel wrapper: builds ``csrc/prism_attention.cu`` at
first use and launches it through ctypes.

The CUDA kernel replaces the TPU kernel
``repro/kernels/prism_attention/kernel.py:prism_attention_pallas``; its
source note says what bounds it and how it is laid out.  Unlike the Pallas
kernel it takes a mask on the local keys, any Nq and Nk, and a query
offset, so the padded ViT exchange runs on it, and it reads the means
where the exchange's gather leaves them.  Its query/key width and its
value width are apart (``WIDTHS``): DeepSeek-V2's MLA exchange attends 192
wide keys (the expanded latent and the rotary key) and 128 wide values.
``row_plan`` picks the warps of its bf16 body.

``prism_attention`` takes its plain version for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises — it never falls back.  It
counts its launches in ``prism_attention.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.nvcc import CudaLibrary
from repro_torch.kernels.prism_attention.ref import prism_attention_ref

# (query/key width, value width) pairs the kernel is instantiated for
WIDTHS = ((16, 16), (64, 64), (128, 128), (192, 128))
ROWS = 32                          # GMAX in the CUDA source: G may not exceed it
MAX_WARPS = 8                      # consumer warps of 16 query rows (bf16)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.prism_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.prism_attention_attributes
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "prism_attention.cu", _bind)


def row_plan(rows: int) -> int:
    """Consumer warps per CTA of the bf16 body (each CTA has one producer
    warp more) for ``rows`` = Nq·G query rows of a (batch row, KV head):
    as few CTAs of at most ``MAX_WARPS`` warps of 16 rows as hold them,
    the rows spread evenly over those CTAs.  The ViT shape (100 rows) is
    one CTA of 7 consumer warps."""
    ctas = -(-rows // (16 * MAX_WARPS))
    return -(-rows // (16 * ctas))


def attributes(dh: int, dtype: torch.dtype, out_dtype: torch.dtype,
               warps: int = MAX_WARPS, dv: Optional[int] = None) -> dict:
    """Registers, spilled bytes, shared memory per CTA and resident CTAs
    per SM of one instantiation (query/key width ``dh``, value width
    ``dv``, ``dh`` by default; bf16 inputs: the tensor-core body with
    ``warps`` consumer warps; f32: the CUDA-core body), read from the
    loaded library on the current card."""
    out = (ctypes.c_int * 4)()
    rc = LIBRARY.lib().prism_attention_attributes(
        dh, dh if dv is None else dv, int(dtype == torch.bfloat16),
        int(out_dtype == torch.float32), warps, out)
    if rc != 0:
        raise RuntimeError(f"prism_attention_attributes failed: code {rc}")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "ctas_per_sm"), out))


def mean_layout(km: torch.Tensor) -> Tuple[int, int, int, int]:
    """(P, L, stride over B, stride over P), in elements, of means given
    flat as ``[B, M, Hk, dh]`` (P = 1, L = M) or as the exchange's
    ``[B, P, L, Hk, dh]`` view."""
    if km.ndim == 4:
        return 1, km.shape[1], km.stride(0), 0
    return km.shape[1], km.shape[2], km.stride(0), km.stride(1)


def _inner_contiguous(t: torch.Tensor, dims: int) -> bool:
    """Are the last ``dims`` dims of ``t`` laid out densely, row-major?"""
    want = 1
    for n, st in zip(reversed(t.shape[-dims:]), reversed(t.stride()[-dims:])):
        if n > 1 and st != want:
            return False
        want *= n
    return True


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
        if name not in ("k_means", "v_means") and not t.is_contiguous():
            raise ValueError(f"prism_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"prism_attention: {name} must be 16-byte "
                             f"aligned")
    if q.ndim != 4 or k.ndim != 4 or v.shape[:3] != k.shape[:3] \
            or km.ndim not in (4, 5) or vm.shape[:-1] != km.shape[:-1]:
        raise ValueError(f"prism_attention: q {tuple(q.shape)} must be "
                         f"[B,Nq,H,dh], k {tuple(k.shape)} [B,Nk,Hk,dh], v "
                         f"{tuple(v.shape)} [B,Nk,Hk,dv], means "
                         f"{tuple(km.shape)} / {tuple(vm.shape)} "
                         f"[B,M,Hk,·] or [B,P,L,Hk,·]")
    B, Nq, H, dh = q.shape
    _, Nk, Hk, _ = k.shape
    dv = v.shape[3]
    P, L, _, _ = mean_layout(km)
    if (k.shape[0] != B or k.shape[3] != dh or km.shape[0] != B
            or km.shape[-2:] != k.shape[2:] or vm.shape[-1] != dv
            or tuple(bias.shape) != (B, P * L)):
        raise ValueError(f"prism_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, means "
                         f"{tuple(km.shape)} / {tuple(vm.shape)}, bias "
                         f"{tuple(bias.shape)} disagree")
    vec = 16 // q.element_size()
    for name, t in (("k_means", km), ("v_means", vm)):
        _, _, sb, sp = mean_layout(t)
        if (not _inner_contiguous(t, 3) or (B > 1 and sb % vec)
                or (P > 1 and sp % vec)):
            raise ValueError(f"prism_attention: {name} strides "
                             f"{t.stride()} must be dense inside a "
                             f"partition's (L, Hk, ·) and keep 16-byte "
                             f"rows")
    if kv_mask is not None and (tuple(kv_mask.shape) != (B, Nk)
                                or kv_mask.dtype != torch.bool):
        raise ValueError(f"prism_attention: kv_mask {tuple(kv_mask.shape)} "
                         f"{kv_mask.dtype} must be [B, Nk] bool")
    if (dh, dv) not in WIDTHS:
        raise ValueError(f"prism_attention: widths (dqk, dv) = {(dh, dv)} "
                         f"not in {WIDTHS}")
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
                    v_loc: torch.Tensor,      # [B, Nk, Hk, dv]
                    k_means: torch.Tensor,    # [B, M, Hk, dh] | [B,P,L,Hk,dh]
                    v_means: torch.Tensor,    # the same with dv
                    mean_bias: torch.Tensor,  # [B, M] f32, M = P·L
                    *, causal: bool = True,
                    scale: Optional[float] = None,
                    softcap: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None,  # [B, Nk] bool
                    q_offset: int = 0,
                    out_dtype: Optional[torch.dtype] = None,
                    seen_means: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of q over [local K/V ‖ mean K/V + bias] →
    [B, Nq, H, dv] in ``out_dtype`` (q's dtype by default; float32 gives
    the result before its rounding to bf16, for checks).  The means may be
    flat or the exchange's ``[B, P, L, Hk, dh]`` view, strided over B and
    P (mean ``p·L + l`` is ``[:, p, l]``); the kernel reads them in place.

    CPU tensors take the plain version (``prism_attention_ref``); CUDA
    tensors launch the kernel on the current stream; meta tensors take the
    shape function (``kernels.meta``), which counts ``seen_means`` means a
    query (None: all of them)."""
    if q.device.type == "cpu":
        if k_means.ndim == 5:
            k_means = k_means.flatten(1, 2)
            v_means = v_means.flatten(1, 2)
        return prism_attention_ref(q, k_loc, v_loc, k_means, v_means,
                                   mean_bias, causal=causal, scale=scale,
                                   logit_softcap=softcap, kv_mask=kv_mask,
                                   q_offset=q_offset, out_dtype=out_dtype)
    if q.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.prism_attention(
            q, k_loc, v_loc, mean_bias, kv_mask, causal=causal,
            q_offset=q_offset, out_dtype=out_dtype or q.dtype,
            seen_means=seen_means)
    if q.device.type != "cuda":
        raise ValueError(f"prism_attention: no kernel for device {q.device}")
    _check(q, k_loc, v_loc, k_means, v_means, mean_bias, kv_mask)
    B, Nq, H, dh = q.shape
    Nk, Hk, dv = k_loc.shape[1], k_loc.shape[2], v_loc.shape[3]
    P, L, sb, sp = mean_layout(k_means)
    _, _, vsb, vsp = mean_layout(v_means)
    scale = (dh ** -0.5) if scale is None else scale
    out_dtype = q.dtype if out_dtype is None else out_dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"prism_attention: out_dtype {out_dtype} not "
                        f"{q.dtype} or float32")
    out = torch.empty((B, Nq, H, dv), dtype=out_dtype, device=q.device)
    lib = LIBRARY.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.prism_attention_launch(
            q.data_ptr(), k_loc.data_ptr(), v_loc.data_ptr(),
            k_means.data_ptr(), v_means.data_ptr(), mean_bias.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
            B, Nq, Nk, P, L, sb, sp, vsb, vsp, H, Hk, dh, dv,
            int(q.dtype == torch.bfloat16), int(out_dtype == torch.float32),
            int(causal), int(q_offset), float(scale), float(softcap or 0.0),
            row_plan(Nq * (H // Hk)), stream)
    if rc != 0:
        raise RuntimeError(f"prism_attention kernel launch failed: code {rc}")
    prism_attention.launches += 1
    return out


prism_attention.launches = 0
