"""The meta route of the four kernels: a shape function for each.

A tensor on the meta device has a shape and a dtype and no data, and the
dry run (``repro_torch.launch.dryrun``) traces a rank's step on such
tensors.  A kernel wrapper given one calls its shape function here
instead of the CUDA kernel or the plain version: it returns empty meta
outputs of the kernel's output shapes and dtypes, and books to the step
counter running (``launch.hlo_analysis.book_kernel``) the kernel's own
FLOPs and HBM bytes as PERF.md §6's bound counts them: each operand read
once and each output written once, and the operations over the pairs the
kernel keeps.  A plain version would charge the card for tensors the
kernel never holds (the plain PRISM attention's whole ``[B, H, N, N +
means]`` scores).

Meta tensors hold no values, so what the data decides is counted from
what the caller knows: a decode's valid positions from an integer
``cache_len`` (every position of a row when it is a tensor), PRISM
attention's visible means from the partition (``seen_means``; empty
segments and masked keys are counted as present), causal pairs from the
query offset.  No kernel launches, and no launch is counted.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _n(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _book(name: str, flops: float, moved: float) -> None:
    from repro_torch.launch.hlo_analysis import book_kernel
    book_kernel(name, flops, moved)


def flash_decode(q, k, bias, positions: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``kernels.flash_decode.flash_decode`` on meta: (o·l [B, H, dh],
    m [B, H], l [B, H]) f32; q, the bias and the K and V rows of the
    ``positions`` that count (default every row's S) in, 4·H·dh FLOPs a
    position."""
    B, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    pos = B * S if positions is None else positions
    o = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    _book("flash_decode", 4 * H * dh * pos,
          _n(q) + _n(bias) + 2 * pos * Hk * dh * k.element_size()
          + _n(o) + _n(m) + _n(l))
    return o, m, l


def flash_decode_paged(q, k_pool, page_table, bias
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_decode_paged`` on meta: the same outputs; every row's
    ``MP·ps`` positions counted, the K and V rows at most the pool's."""
    B, H, dh = q.shape
    P, ps, Hk = k_pool.shape[:3]
    pos = B * page_table.shape[1] * ps
    o = torch.empty((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H), dtype=torch.float32, device=q.device)
    rows = min(pos, P * ps)
    _book("flash_decode_paged", 4 * H * dh * pos,
          _n(q) + _n(page_table) + _n(bias)
          + 2 * rows * Hk * dh * k_pool.element_size()
          + _n(o) + _n(m) + _n(l))
    return o, m, l


def segment_means(xs, L: int, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """``segment_means``/``segment_means_kv`` on meta, ``xs`` one or two
    ``[B, N, D]`` inputs → (means ``[len(xs), B, L, D]``, counts ``[B, L]``
    f32); the inputs and the mask in, 2 FLOPs an input element (x·mask,
    add)."""
    B, N, D = xs[0].shape
    out = torch.empty((len(xs), B, L, D), dtype=xs[0].dtype,
                      device=xs[0].device)
    counts = torch.empty((B, L), dtype=torch.float32, device=xs[0].device)
    _book("segment_means", 2 * len(xs) * B * N * D,
          sum(_n(x) for x in xs) + _n(mask) + _n(out) + _n(counts))
    return out, counts


def causal_pairs(Nq: int, Nk: int, q_offset: int) -> int:
    """(query, local key) pairs of causal attention: query i sees the
    ``min(q_offset + i + 1, Nk)`` keys at or before its position."""
    a = q_offset + 1
    t = min(max(Nk - a + 1, 0), Nq)          # queries that see < all keys
    return t * a + t * (t - 1) // 2 + (Nq - t) * Nk


def prism_attention(q, k, v, bias, kv_mask, *, causal: bool, q_offset: int,
                    out_dtype, seen_means: Optional[int] = None
                    ) -> torch.Tensor:
    """``prism_attention`` on meta → ``[B, Nq, H, dv]`` in ``out_dtype``;
    q, the bias, the mask and the K and V rows a query row reads (its
    local keys, causal ones at or before it, and ``seen_means`` means,
    default all of them) in, the output out; 2·H·(dh + dv) FLOPs a
    (query, key) pair."""
    B, Nq, H, dh = q.shape
    Nk, Hk, dv = k.shape[1], k.shape[2], v.shape[3]
    M = bias.shape[1]
    seen = M if seen_means is None else seen_means
    local = causal_pairs(Nq, Nk, q_offset) if causal else Nq * Nk
    pairs = B * (local + Nq * seen)
    keys = (min(q_offset + Nq, Nk) if causal else Nk) + seen
    out = torch.empty((B, Nq, H, dv), dtype=out_dtype, device=q.device)
    _book("prism_attention", 2 * H * (dh + dv) * pairs,
          _n(q) + _n(bias) + _n(kv_mask) + _n(out)
          + B * keys * Hk * (dh + dv) * k.element_size())
    return out
