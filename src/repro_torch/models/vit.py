"""ViT encoder — the paper's evaluation workload (ViT-B/16, CIFAR-10 at
224², N = 197 tokens).

Port of ``repro.models.vit``.  Bidirectional attention with the PRISM /
Voltage / local exchange threaded through every block; the classifier head
reads the CLS token.  Layer parameters are a list of per-layer dicts walked
in a loop (the JAX package's ``lax.scan(checkpoint)``; serving keeps no
activations for a backward, so there is nothing to rematerialise).

Sequence padding: 197 is not divisible by P partitions, so tokens are
padded to ``pad_len(197, P, L)`` and the pads are excluded by the key mask
(mask-aware segment means: zero probability mass on pads).

Under a partitioned plan (``voltage``/``prism``) the forward runs SPMD on
every rank of the seq group: each rank embeds all tokens, keeps its slice
of the activations and of the key mask, and runs the blocks with the
exchange; rank 0, which holds CLS, computes the head, and the logits are
broadcast so every rank returns the same ``[B, classes]``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import (ExchangeConfig, exchange_attention,
                                       partitioned, seq_group_for)
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       init_mlp, init_norm, project_qkv)
from repro_torch.models.transformer import _attn_spec, pad_len

Params = Dict[str, Any]

PATCH = 16
IMAGE = 224
N_PATCHES = (IMAGE // PATCH) ** 2          # 196
N_TOKENS = N_PATCHES + 1                   # + CLS = 197


def init_vit(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """ViT parameters drawn from ``gen`` on its device (the JAX package's
    distributions, not its numbers)."""
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    patch_dim = PATCH * PATCH * 3

    def normal(*shape):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def layer():
        return {"ln1": init_norm(cfg.norm_type, d, dev),
                "attn": {name: dense_init(gen, d, d, dtype)
                         for name in ("wq", "wk", "wv", "wo")},
                "ln2": init_norm(cfg.norm_type, d, dev),
                "mlp": init_mlp(gen, d, cfg.d_ff, dtype, gated=False)}

    return {
        "patch_embed": dense_init(gen, patch_dim, d, dtype),
        "patch_bias": torch.zeros((d,), dtype=dtype, device=dev),
        "cls": normal(1, 1, d),
        "pos": normal(1, N_TOKENS, d),
        "layers": [layer() for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg.norm_type, d, dev),
        "head": dense_init(gen, d, cfg.vocab_size, dtype, scale=0.02),
        "head_bias": torch.zeros((cfg.vocab_size,), dtype=dtype, device=dev),
    }


def patchify(images: torch.Tensor) -> torch.Tensor:
    """[B, 224, 224, 3] → [B, 196, 768] raw patch vectors."""
    B = images.shape[0]
    g = IMAGE // PATCH
    x = images.reshape(B, g, PATCH, g, PATCH, 3)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, N_PATCHES, PATCH * PATCH * 3)


def forward_vit(params: Params, images: torch.Tensor, cfg: ModelConfig,
                xcfg: ExchangeConfig) -> torch.Tensor:
    """[B, 224, 224, 3] → class logits [B, n_classes] f32."""
    B = images.shape[0]
    x = patchify(images.to(cfg.torch_dtype)) @ params["patch_embed"]
    x = x + params["patch_bias"]
    x = torch.cat([params["cls"].expand(B, 1, x.shape[-1]), x], dim=1)
    x = x + params["pos"]

    # pad so every partition divides into L integer segments
    N = pad_len(N_TOKENS, max(xcfg.seq_shards, 1), max(xcfg.L, 1))
    x = F.pad(x, (0, 0, 0, N - N_TOKENS))
    kv_mask = (torch.arange(N, device=x.device) < N_TOKENS)[None].expand(B, N)

    group = seq_group_for(xcfg) if partitioned(xcfg) else None
    if group is not None:                  # keep this rank's partition
        Np = N // group.world_size
        part = slice(group.rank * Np, (group.rank + 1) * Np)
        x, kv_mask = x[:, part], kv_mask[:, part]
    # a copy, not a view: at B 1 a later rank's slice is contiguous but
    # starts mid-row, and the kernels read the mask in 16-byte lanes
    kv_mask = kv_mask.clone(memory_format=torch.contiguous_format)

    spec = _attn_spec(cfg, causal=False, use_rope=False)
    for lp in params["layers"]:
        xin = apply_norm(cfg.norm_type, lp["ln1"], x)
        q, k, v = project_qkv(lp["attn"], xin, spec, None)
        h = exchange_attention(q, k, v, xcfg, causal=False, kv_mask=kv_mask)
        x = x + h.reshape(*x.shape[:2], -1) @ lp["attn"]["wo"]
        h2 = apply_mlp(lp["mlp"], apply_norm(cfg.norm_type, lp["ln2"], x),
                       cfg.act)
        x = x + h2

    def head(cls_token):
        cls_token = apply_norm(cfg.norm_type, params["final_norm"],
                               cls_token)
        return (cls_token @ params["head"] + params["head_bias"]).float()

    if group is None:
        return head(x[:, 0])
    logits = (head(x[:, 0]) if group.rank == 0 else
              torch.empty((B, cfg.vocab_size), dtype=torch.float32,
                          device=x.device))
    return group.broadcast(logits, src=0)
