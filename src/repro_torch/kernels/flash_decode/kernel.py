"""Flash-decode kernel wrapper: builds ``csrc/flash_decode.cu`` at first
use and launches it through ctypes.  The same library holds the paged
entry point that ``paged.py`` wraps: one kernel body serves both layouts.

The CUDA kernel replaces the TPU kernel
``repro/kernels/flash_decode/kernel.py:flash_decode_pallas``; its source
note says what bounds it (bytes: K and V read once) and how it is laid out.
``split_plan`` picks how many CTAs (one cluster) share one (row, KV head)
along S.

``flash_decode`` takes its plain version for a tensor on the CPU and its
shape function for one on the meta device (``kernels.meta``: the dry run).
For a CUDA tensor it launches the kernel or raises — it never falls back.
It counts its launches in ``flash_decode.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.nvcc import CudaLibrary

HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 8                      # GMAX in the CUDA source
MAX_SPLITS = 8                     # a cluster's CTAs, MAX_SPLITS there


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_decode_paged_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_decode_attributes
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(Path(__file__).resolve().parent / "csrc"
                      / "flash_decode.cu", _bind)


def tile_size(dtype: torch.dtype, dh: int) -> int:
    """Cache positions per kernel tile, TS in the CUDA source: 128 in bf16
    (16 per warp for the tensor cores); in f32 a K tile of 16 KB (256
    positions at dh 16, 64 at dh 64, 32 at dh 128)."""
    return 128 if dtype == torch.bfloat16 else 4096 // dh


def split_plan(B: int, Hk: int, S: int, n_sm: int, tile: int = 128) -> int:
    """CTAs along S for each (row, KV head), one cluster of at most
    ``MAX_SPLITS``.  One CTA fits an SM, so ``B·Hk·splits`` stays within
    one wave of the ``n_sm`` SMs: 1 where B·Hk CTAs fill half the card or
    S fits one tile; else ``n_sm // (B·Hk)`` as far as the tiles and the
    cap allow, each split a whole number of tiles and none empty (the
    kernel gives split i the tiles ``[i·per, min(tiles, (i+1)·per))`` with
    ``per = ceil(tiles / splits)``)."""
    tiles = -(-S // tile)
    want = min(tiles, MAX_SPLITS, n_sm // (B * Hk))
    if want <= 1:
        return 1
    per = -(-tiles // want)
    return -(-tiles // per)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(device: torch.device, dtype: torch.dtype, B: int, Hk: int,
             S: int, dh: int) -> int:
    """``split_plan`` for a launch on ``device``."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return split_plan(B, Hk, S, sm_count(index), tile_size(dtype, dh))


def attributes(paged: bool, dh: int, dtype: torch.dtype,
               group: int) -> dict:
    """Registers, spilled bytes, shared memory per CTA and resident CTAs
    per SM of one instantiation (``group`` query heads per KV head: the
    f32 kernel is built for groups of up to 4 and of up to 8, the bf16 one
    for up to 8), read from the loaded library on the current card."""
    out = (ctypes.c_int * 4)()
    rc = LIBRARY.lib().flash_decode_attributes(
        int(paged), dh, int(dtype == torch.bfloat16), group, out)
    if rc != 0:
        raise RuntimeError(f"flash_decode_attributes failed: code {rc}")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "ctas_per_sm"), out))


def _check(q, k, v, bias):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"flash_decode: {name} on {t.device}, q on {dev}")
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be [B,H,dh] "
                         f"and k/v {tuple(k.shape)}/{tuple(v.shape)} "
                         f"[B,S,Hk,dh]")
    B, H, dh = q.shape
    _, S, Hk, dhk = k.shape
    if k.shape[0] != B or dhk != dh or tuple(bias.shape) != (B, S):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, bias {tuple(bias.shape)} "
                         f"disagree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {dh} not in {HEAD_DIMS}")
    if S < 1 or H % Hk or H // Hk > MAX_GROUP:
        raise ValueError(f"flash_decode: S={S}, H={H}, Hk={Hk} unsupported "
                         f"(H must be a multiple of Hk, at most "
                         f"{MAX_GROUP}x)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_decode: dtype {q.dtype} not bf16/f32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype} must match")
    if bias.dtype != torch.float32:
        raise TypeError(f"flash_decode: bias must be f32, got {bias.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned")


def flash_decode(q: torch.Tensor,        # [B, H, dh]
                 k: torch.Tensor,        # [B, S, Hk, dh]
                 v: torch.Tensor,
                 kv_bias: torch.Tensor,  # [B, S] f32
                 *, scale: Optional[float] = None,
                 softcap: Optional[float] = None,
                 positions: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention partials (o·l [B,H,dh], m [B,H], l [B,H]), f32.

    CPU tensors take the plain version (``flash_decode_ref``); CUDA tensors
    launch the kernel on the current stream; meta tensors take the shape
    function (``kernels.meta``), which counts ``positions`` valid cache
    positions over the rows (None: all)."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, kv_bias, scale=scale,
                                softcap=softcap)
    if q.device.type == "meta":
        from repro_torch.kernels import meta
        return meta.flash_decode(q, k, kv_bias, positions)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _check(q, k, v, kv_bias)
    B, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    scale = (dh ** -0.5) if scale is None else scale
    o = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    splits = plan_for(q.device, q.dtype, B, Hk, S, dh)
    lib = LIBRARY.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_bias.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Hk, S, dh,
            int(q.dtype == torch.bfloat16), splits, float(scale),
            float(softcap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: code {rc}")
    flash_decode.launches += 1
    return o, m, l


flash_decode.launches = 0
