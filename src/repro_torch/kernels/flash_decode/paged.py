"""Paged flash-decode: one-token attention read through a page table.

Port of ``repro.kernels.flash_decode.paged``.  The KV cache lives in a
shared pool of fixed-size pages (``[n_pages, page_size, Hk, dh]``); each
request owns a row of a ``[B, max_pages]`` int32 page table mapping its
logical block ``p`` to a physical page id.

* ``gather_pages`` / ``flash_decode_paged_ref`` — the plain version: the
  gather materialised by indexing, then the dense plain math.
* ``flash_decode_paged`` — the wrapper of the paged entry point of the
  CUDA kernel ``csrc/flash_decode.cu`` (replaces the TPU kernel
  ``flash_decode_paged_pallas``), which runs the dense kernel's body with
  each position's page resolved in-kernel and never materialises the
  gather.  A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel or raises — it never
  falls back.  Launches are counted in ``flash_decode_paged.launches``.
* ``flash_decode_paged_op`` — the validity bias from ``cache_len`` (the
  dense op's ``validity_bias``) and the call above.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_decode.kernel import (HEAD_DIMS, LIBRARY,
                                                     MAX_GROUP)
from repro_torch.kernels.flash_decode.ops import validity_bias
from repro_torch.kernels.flash_decode.ref import flash_decode_ref


def gather_pages(pool: torch.Tensor,         # [P, ps, Hk, dh]
                 page_table: torch.Tensor    # [B, MP] int
                 ) -> torch.Tensor:          # [B, MP*ps, Hk, dh]
    """Materialise a per-request contiguous KV view from the page pool."""
    B, MP = page_table.shape
    ps = pool.shape[1]
    return pool[page_table.long()].reshape(B, MP * ps, *pool.shape[2:])


def flash_decode_paged_ref(q: torch.Tensor,           # [B, H, dh]
                           k_pool: torch.Tensor,      # [P, ps, Hk, dh]
                           v_pool: torch.Tensor,
                           page_table: torch.Tensor,  # [B, MP] int32
                           kv_bias: torch.Tensor,     # [B, MP*ps] f32
                           *, scale: Optional[float] = None,
                           softcap: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Gather + the dense plain math → (o·l, m, l), all f32."""
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    return flash_decode_ref(q, k, v, kv_bias, scale=scale, softcap=softcap)


def _check(q, k_pool, v_pool, page_table, bias):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"flash_decode_paged: {name} on {t.device}, q "
                             f"on {dev}")
    if (q.ndim != 3 or k_pool.ndim != 4 or v_pool.shape != k_pool.shape
            or page_table.ndim != 2):
        raise ValueError(f"flash_decode_paged: q {tuple(q.shape)} must be "
                         f"[B,H,dh], pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} [P,ps,Hk,dh], page table "
                         f"{tuple(page_table.shape)} [B,MP]")
    B, H, dh = q.shape
    _, ps, Hk, dhk = k_pool.shape
    MP = page_table.shape[1]
    if (page_table.shape[0] != B or dhk != dh
            or tuple(bias.shape) != (B, MP * ps)):
        raise ValueError(f"flash_decode_paged: shapes q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}, page table "
                         f"{tuple(page_table.shape)}, bias "
                         f"{tuple(bias.shape)} disagree")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_decode_paged: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if H % Hk or H // Hk > MAX_GROUP:
        raise ValueError(f"flash_decode_paged: H={H}, Hk={Hk} unsupported "
                         f"(H must be a multiple of Hk, at most "
                         f"{MAX_GROUP}x)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_decode_paged: dtype {q.dtype} not bf16/f32")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"flash_decode_paged: q {q.dtype}, pools "
                        f"{k_pool.dtype}/{v_pool.dtype} must match")
    if page_table.dtype != torch.int32:
        raise TypeError(f"flash_decode_paged: page table must be int32, "
                        f"got {page_table.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"flash_decode_paged: bias must be f32, got "
                        f"{bias.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode_paged: {name} must be "
                             f"contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:          # the kernel's 16-byte row loads
            raise ValueError(f"flash_decode_paged: {name} must be 16-byte "
                             f"aligned")


def flash_decode_paged(q: torch.Tensor,           # [B, H, dh]
                       k_pool: torch.Tensor,      # [P, ps, Hk, dh]
                       v_pool: torch.Tensor,
                       page_table: torch.Tensor,  # [B, MP] int32
                       kv_bias: torch.Tensor,     # [B, MP*ps] f32
                       *, scale: Optional[float] = None,
                       softcap: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged one-token attention partials (o·l [B,H,dh], m [B,H],
    l [B,H]), f32.

    CPU tensors take the plain version (``flash_decode_paged_ref``); CUDA
    tensors launch the kernel on the current stream.  Page ids must lie
    in ``[0, P)``: they are not checked on the card (that would cost a
    device→host copy per step)."""
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, k_pool, v_pool, page_table,
                                      kv_bias, scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_paged: no kernel for device "
                         f"{q.device}")
    _check(q, k_pool, v_pool, page_table, kv_bias)
    B, H, dh = q.shape
    P, ps, Hk = k_pool.shape[:3]
    MP = page_table.shape[1]
    scale = (dh ** -0.5) if scale is None else scale
    o = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    lib = LIBRARY.lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_decode_paged_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), kv_bias.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, H, Hk, P, ps, MP, dh,
            int(q.dtype == torch.bfloat16), float(scale),
            float(softcap or 0.0), stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode_paged kernel launch failed: "
                           f"code {rc}")
    flash_decode_paged.launches += 1
    return o, m, l


flash_decode_paged.launches = 0


def flash_decode_paged_op(q: torch.Tensor,        # [B, 1, H, dh] / [B,H,dh]
                          k_pool: torch.Tensor,   # [P, ps, Hk, dh]
                          v_pool: torch.Tensor,
                          page_table: torch.Tensor,   # [B, MP] int
                          cache_len,                  # [B] valid prefix
                          *, scale: Optional[float] = None,
                          softcap: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Bias construction + the paged partial-attention kernel (its plain
    version for CPU tensors) → (o·l, m, l).  The pools are used as they
    are, never copied."""
    if q.ndim == 4:
        q = q[:, 0]
    B = q.shape[0]
    ps, MP = k_pool.shape[1], page_table.shape[1]
    bias = validity_bias(B, MP * ps, cache_len, device=q.device)
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    return flash_decode_paged(q.contiguous(), k_pool, v_pool, table, bias,
                              scale=scale, softcap=softcap)
