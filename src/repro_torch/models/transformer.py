"""Transformer stacks — the dense decoder family (llama / qwen / internlm,
and gemma2's local/global alternation), the moe family (deepseek-moe, and
deepseek-v2 with MLA attention), the encoder-decoder audio family
(whisper), the vlm family (llama-3.2-vision: cross-attention to image
tokens), the hybrid family (hymba: attention and Mamba heads side by side)
and the ssm family (xLSTM: mLSTM and sLSTM blocks).

Port of ``repro.models.transformer``, every family of it.
Layer parameters are Python lists of per-layer dicts walked in a loop (in
place of the JAX package's stacked ``lax.scan`` layout), one list a stack
(``layer_stacks``); under grad ``forward_lm`` and whisper's encoder
rematerialise every entry of the walk (``models.remat``: the reference's
``jax.checkpoint`` around each scanned layer):

* dense: ``params["layers"]``, or for gemma2 (``cfg.local_global``)
  ``params["local_layers"]`` and ``params["global_layers"]``,
  ``n_layers // 2`` each, walked in pairs — the local layer under the
  sliding ``cfg.window``, then the global one;
* moe: ``params["first_layers"]`` (``moe.first_dense_layers`` layers with
  a dense MLP), then ``params["layers"]`` (routed and shared experts,
  ``models.moe``); attention is GQA, or MLA (``models.mla``) where
  ``cfg.mla`` is set.  ``forward_lm`` returns the experts' summed
  load-balance loss as its ``aux``;
* audio: ``params["enc_layers"]`` (``encoder_layers`` non-causal dense
  layers over the frames, then ``enc_norm``) and ``params["dec_layers"]``
  (causal self-attention, then cross-attention to the encoder memory
  (``ln_x``, ``xattn``), then the MLP);
* vlm: ``params["self_layers"]`` (``n_layers // cross_attn_every`` groups
  of ``cross_attn_every − 1`` dense layers, one list in walk order) and
  ``params["cross_layers"]``, one a group after its dense layers
  (cross-attention to the image tokens through ``tanh(gate)``, then the
  MLP);
* hybrid: ``params["layers"]``, each attention and a Mamba mixer
  (``models.ssm``) over the same normed input, each path normed and the
  two averaged, then the MLP.  ``n_heads · hd`` must equal ``d_model``
  (every hymba config): ``attn_norm`` is ``n_heads · hd`` wide and norms
  the d-wide ``wo`` output, so the JAX package's layer cannot run at
  another width either, and the port refuses it;
* ssm: ``params["groups"]``, ``n_layers // slstm_every`` groups, each a
  dict of ``slstm_every − 1`` mLSTM blocks (the lists ``mlstm`` and
  ``m_ln``, one norm a block) and then one sLSTM block (``slstm``,
  ``s_ln``); no attention and no MLP.

The memory (the encoded frames, or the image embeddings) is padded to
``pad_len(M0, P, L)`` with a key mask.  Each cross layer projects it to
K and V once (``_memory_kv``); a full-sequence query attends through
``exchange.exchange_cross_attention``, a decode step's one token through
``exchange.decode_attention_sharded`` (the flash-decode kernel; across
ranks the exact merge) over the ``valid`` real memory tokens.

The decode cache keeps the stacked layout, one half a stack: ``{"kv":
{leaf: [n_layers, B, S, ...]}}``, gemma2's ``{"local": ..., "global":
...}`` stacked over the pairs, or the moe family's ``{"first": ...,
"kv": ...}`` (MLA: the latent leaves ``c_kv`` ``[.., B, S, r]`` and
``k_pe`` ``[.., B, S, dr]``), and each layer updates its slice of it in
place.  audio's ``{"kv", "mem_kv", "mem_mask"}`` and vlm's ``{"self",
"mem_kv", "mem_mask"}`` add the memory: ``mem_kv`` ``{"k", "v": [n_cross,
B, M, Hk, dh]}`` (one entry a cross layer) and the key mask ``[B, M]``,
filled once a request by ``prefill_memory``.  hybrid's is ``{"kv": ...,
"ssm": {"h": [n_layers, B, di, S] f32, "conv": [n_layers, B, W − 1,
di]}}``, ssm's ``{"m": {"C", "n", "m": [G, n_m, B, ...]}, "s": {"c",
"n", "h", "m": [G, B, D]}}``, the recurrent states f32: the JAX package's
layout, so the bridge and the slot pool address the same axes (each
leaf's batch axis is the one whose size follows B).

Entry points:
  init_lm(cfg, gen)                        → params dict
  forward_lm(params, batch, cfg, xcfg, last_only) → (logits, aux)
  init_decode_cache(cfg, B, S, device, xcfg) → cache dict
  prefill_memory(params, batch, cfg, xcfg, cache) → cache with its memory
  prefill(params, batch, cache, cfg, xcfg) → (last logits, primed cache)
  decode_step(params, batch, cache, i, cfg, xcfg) → (logits, cache)
  init_page_pool(cfg, n_pages, page_size, device) → paged pool dict
  decode_step_paged(params, batch, pool, page_table, lengths, cfg, xcfg)
                                           → (logits, pool)

Under a partitioned plan (``voltage``, ``prism`` over the ranks of a
``repro_torch.core.seq_group``) every rank calls these with the same
global inputs.  ``forward_lm`` and ``prefill`` keep rank p's tokens
``[p·Np, (p+1)·Np)`` at their global positions, with one exchange a
layer; ``forward_lm`` returns the global logits on every rank.  The
decode cache is sharded in contiguous blocks along S: rank p holds
positions ``[p·Sp, (p+1)·Sp)``, and each decode step merges every
block's partial attention (``exchange.decode_attention_sharded``).
The memory splits the same way: rank p holds frames or image tokens
``[p·Mp, (p+1)·Mp)`` of the padded memory (its padding a suffix of the
last blocks).  whisper's encoder runs each rank's block at its global
positions under the plan's exchange, with no key mask, as the JAX
package's encoder attends its own padded frames; the decode cache keeps
the rank's block of ``mem_kv`` and the global mask, so every rank knows
the memory's real length.

On a mesh row under tensor parallelism (``repro_torch.models.tp``, set
by the mesh step) every rank of the row runs the same tokens with its
block of the split weights: its heads (the decode cache holds its KV
heads), its MLP columns, its experts, its vocabulary rows; each split
region sums its partial products over the row, ``forward_lm`` and
``decode_step`` gather the vocab-parallel logits, and the layers' regions
are rematerialised with the row's collectives taped.

Under a partitioned plan a windowed layer's prefill exchanges only its
halo under ``prism`` (``exchange.prism_prefill_attention``) and its decode
merges the blocks' windowed partials.  A MoE layer routes a rank's tokens
as the whole sequence's (one staged call of counts a layer,
``moe.apply_moe``); its decode, whose token every rank holds, makes none.
A recurrent mixer (Mamba, mLSTM, sLSTM) starts from the state the mixer
ended with on the rank before (``core.handoff``: one message a mixer down
the chain of ranks, exact); hymba's attention in the same layer runs the
plan's exchange.  Their decode keeps a full copy of the recurrent state
on every rank, updated alike, with no staged call; hymba's KV cache is
sharded and merged as the dense family's.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import (ExchangeConfig, ExchangeMode,
                                       decode_attention_sharded,
                                       exchange_attention,
                                       exchange_cross_attention, gather_kv,
                                       partitioned, seq_group_for)
from repro_torch.core.handoff import handoff_scan
from repro_torch.models import mla as mla_mod
from repro_torch.models import remat
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import tp as tpm
from repro_torch.models.layers import (AttnSpec, apply_mlp, apply_norm,
                                       attention_block, attention_decode,
                                       attention_decode_paged,
                                       attention_output,
                                       embed, init_attention, init_embedding,
                                       init_kv_cache, init_mlp, init_norm,
                                       kv_weights, prefill_kv_cache,
                                       project_qkv, unembed)
from repro_torch.models.moe import apply_moe, init_moe

Params = Dict[str, Any]

# single-pass prefill is defined for the attention-cached families; the
# recurrent ones (hybrid: mamba's conv and SSM state, ssm: xLSTM) prefill by
# the teacher-forced decode loop, as in the JAX package
PREFILL_FAMILIES = ("dense", "moe", "audio", "vlm")

# the decoder families (every one of the JAX package's)
FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid", "ssm")

# the families that cross-attend to a memory (encoder frames, image tokens)
MEMORY_FAMILIES = ("audio", "vlm")

# ``_walk``'s half of a layer that attends the memory: its K and V are the
# cache's ``mem_kv`` entry of its index
MEMORY = "mem_kv"


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no decoder stack (families: "
            f"{FAMILIES})")
    if cfg.family == "hybrid" and cfg.n_heads * cfg.hd != cfg.d_model:
        raise ValueError(
            f"hymba needs n_heads·hd == d_model ({cfg.n_heads}·{cfg.hd} ≠ "
            f"{cfg.d_model}): attn_norm is n_heads·hd wide and norms the "
            f"d-wide wo output (the JAX package's layer raises there too)")


def _attn_spec(cfg: ModelConfig, *, window: Optional[int] = None,
               causal: Optional[bool] = None, use_rope: bool = True) -> AttnSpec:
    """A layer's attention spec; under tensor parallelism over the heads
    (``tp.heads``) the rank's query and KV heads."""
    tp, h = tpm.heads(cfg)
    h = h or tpm.Heads(0, cfg.n_heads, 0, cfg.n_kv_heads)
    return AttnSpec(
        n_heads=h.n_q, n_kv=h.n_kv, head_dim=cfg.hd,
        causal=cfg.causal if causal is None else causal,
        window=window, logit_softcap=cfg.attn_softcap,
        rope_theta=cfg.rope_theta, use_rope=use_rope and cfg.rope_theta > 0,
        scale=cfg.query_scale, tp=tp, q0=h.q0, kv0=h.kv0,
        kv_shared=h.shared)


def _mlp(p: Params, x, cfg: ModelConfig, width: int):
    """An MLP of ``width`` (split over the row where ``tp.ffn`` says)."""
    return apply_mlp(p, x, cfg.act, tp=tpm.ffn(width))


def _taped(*groups) -> list:
    """The groups whose collectives a rematerialised layer may call: the
    seq group, and the row and the column of tensor parallelism."""
    out = []
    for g in groups + (tpm.group(), tpm.batch_group()):
        if g is not None and all(g is not o for o in out):
            out.append(g)
    return out


def pad_len(n: int, shards: int, L: int) -> int:
    """Pad a memory length so each of ``shards`` partitions splits into L
    integer segments (mask-aware means handle the remainder exactly)."""
    q = shards * max(L, 1)
    return ((n + q - 1) // q) * q


# ---------------------------------------------------------------------------
# dense layer init / apply
# ---------------------------------------------------------------------------

def _init_dense_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    p = {"ln1": init_norm(cfg.norm_type, d, dev),
         "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                dtype, qkv_bias=cfg.qkv_bias),
         "ln2": init_norm(cfg.norm_type, d, dev),
         "mlp": init_mlp(gen, d, cfg.d_ff, dtype, gated=cfg.act != "gelu")}
    if cfg.post_norms:
        p["post_attn"] = init_norm(cfg.norm_type, d, dev)
        p["post_mlp"] = init_norm(cfg.norm_type, d, dev)
    return p


def _mlp_residual(p: Params, x, h, cfg: ModelConfig):
    """Shared tail of every block: x + h, then x + mlp(ln2(x)); a layer
    without an MLP (whisper's self-attention, whose MLP follows its
    cross-attention) stops at x + h."""
    if cfg.post_norms:
        h = apply_norm(cfg.norm_type, p["post_attn"], h)
    x = x + h
    if "mlp" not in p:
        return x
    h2 = _mlp(p["mlp"], apply_norm(cfg.norm_type, p["ln2"], x), cfg,
              cfg.d_ff)
    if cfg.post_norms:
        h2 = apply_norm(cfg.norm_type, p["post_mlp"], h2)
    return x + h2


def _apply_attn_mlp(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                    positions):
    """Standard pre-norm block: x + attn(ln(x)); x + mlp(ln(x))."""
    h = attention_block(p["attn"], apply_norm(cfg.norm_type, p["ln1"], x),
                        spec, xcfg, positions=positions)
    return _mlp_residual(p, x, h, cfg)


def _attn_prefill(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                  positions, cache, group=None):
    """The attention of a full-sequence block (before its residual) that
    also writes the prompt K/V into the decode cache — same math as
    ``attention_block``.  In a seq group the rank fills its cache block
    with the prompt positions it owns, from the K/V the exchange gathered
    (VOLTAGE) or from a gather of its own (PRISM, and PRISM's halo
    exchange of a windowed layer, booked as ``cache`` bytes, apart from
    the exchange's)."""
    xin = apply_norm(cfg.norm_type, p["ln1"], x)
    q, k, v = project_qkv(p["attn"], xin, spec, positions)
    kw = dict(causal=spec.causal, window=spec.window,
              logit_softcap=spec.logit_softcap, scale=spec.scale)
    if group is None:
        prefill_kv_cache(cache, k, v)
        attn = exchange_attention(q, k, v, xcfg, **kw)
    else:
        seen = []
        attn = exchange_attention(q, k, v, xcfg, **kw,
                                  kv_sink=lambda *kv: seen.append(kv))
        k_all, v_all = (seen[0] if seen
                        else gather_kv(group, k, v, kind="cache"))
        Sp = cache["k"].shape[1]
        lo = group.rank * Sp
        hi = min(lo + Sp, k_all.shape[1])
        if hi > lo:
            prefill_kv_cache(cache, k_all[:, lo:hi], v_all[:, lo:hi])
    return attention_output(p["attn"], attn, spec)


def _apply_attn_mlp_decode(p: Params, x, cfg: ModelConfig, xcfg,
                           spec: AttnSpec, cache, index):
    h, _ = attention_decode(p["attn"],
                            apply_norm(cfg.norm_type, p["ln1"], x), spec,
                            xcfg, cache, index)
    return _mlp_residual(p, x, h, cfg)


def _apply_attn_mlp_decode_paged(p: Params, x, cfg: ModelConfig, xcfg,
                                 spec: AttnSpec, cache, page_table, lengths):
    """Pre-norm block around ``attention_decode_paged`` — the paged twin of
    ``_apply_attn_mlp_decode`` (identical residual/norm/MLP math)."""
    h, _ = attention_decode_paged(
        p["attn"], apply_norm(cfg.norm_type, p["ln1"], x), spec, xcfg,
        cache, page_table, lengths)
    return _mlp_residual(p, x, h, cfg)


# ---------------------------------------------------------------------------
# moe layer init / apply
# ---------------------------------------------------------------------------

def _init_moe_layer(cfg: ModelConfig, gen: torch.Generator,
                    dense_mlp: bool) -> Params:
    """A moe-family layer: GQA or MLA attention, then a dense MLP of
    ``moe.d_ff_dense`` (the first layers) or the experts."""
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    p = {"ln1": init_norm(cfg.norm_type, d, dev),
         "ln2": init_norm(cfg.norm_type, d, dev)}
    if cfg.mla is not None:
        p["attn"] = mla_mod.init_mla(gen, d, cfg.n_heads, cfg.mla, dtype)
    else:
        p["attn"] = init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, dtype, qkv_bias=cfg.qkv_bias)
    if dense_mlp:
        p["mlp"] = init_mlp(gen, d, cfg.moe.d_ff_dense, dtype)
    else:
        p["moe"] = init_moe(gen, d, cfg.moe, dtype)
    return p


def _ffn_residual(p: Params, x, h, cfg: ModelConfig, group=None):
    """Tail of a moe-family block: x + h, then x + ffn(ln2(x)) with the
    layer's dense MLP or its experts (routed as the whole sequence of a
    seq ``group``) → (x, the experts' aux loss or None)."""
    x = x + h
    hin = apply_norm(cfg.norm_type, p["ln2"], x)
    if "moe" in p:
        y, aux = apply_moe(p["moe"], hin, cfg.moe, cfg.act, group=group)
        return x + y, aux
    return x + _mlp(p["mlp"], hin, cfg, cfg.moe.d_ff_dense), None


def _apply_moe_layer(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                     positions, group=None):
    xin = apply_norm(cfg.norm_type, p["ln1"], x)
    if cfg.mla is not None:
        h = mla_mod.mla_block(p["attn"], xin, spec.n_heads, cfg.mla, xcfg,
                              positions=positions, rope_theta=cfg.rope_theta,
                              tp=spec.tp)
    else:
        h = attention_block(p["attn"], xin, spec, xcfg, positions=positions)
    return _ffn_residual(p, x, h, cfg, group)


def _apply_moe_prefill(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                       positions, cache, group=None):
    if cfg.mla is not None:
        h, _ = mla_mod.mla_prefill(
            p["attn"], apply_norm(cfg.norm_type, p["ln1"], x), spec.n_heads,
            cfg.mla, xcfg, cache, positions=positions,
            rope_theta=cfg.rope_theta, tp=spec.tp)
    else:
        h = _attn_prefill(p, x, cfg, xcfg, spec, positions, cache, group)
    return _ffn_residual(p, x, h, cfg, group)[0]


def _apply_moe_decode(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                      cache, index):
    xin = apply_norm(cfg.norm_type, p["ln1"], x)
    if cfg.mla is not None:
        h, _ = mla_mod.mla_decode(p["attn"], xin, spec.n_heads, cfg.mla,
                                  xcfg, cache, index,
                                  rope_theta=cfg.rope_theta, tp=spec.tp)
    else:
        h, _ = attention_decode(p["attn"], xin, spec, xcfg, cache, index)
    return _ffn_residual(p, x, h, cfg)[0]


# ---------------------------------------------------------------------------
# audio / vlm: the memory and the cross-attention layers
# ---------------------------------------------------------------------------

def _init_encdec_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """whisper decoder layer: causal self-attention, cross-attention to the
    encoder memory, MLP."""
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    return {"ln1": init_norm(cfg.norm_type, d, dev),
            "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, dtype),
            "ln_x": init_norm(cfg.norm_type, d, dev),
            "xattn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.hd, dtype),
            "ln2": init_norm(cfg.norm_type, d, dev),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype, gated=cfg.act != "gelu")}


def _init_cross_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """vlm cross-attention layer (to the image tokens, through
    ``tanh(gate)``, the gate an f32 scalar starting at 0) and MLP."""
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    return {"ln1": init_norm(cfg.norm_type, d, dev),
            "xattn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.hd, dtype),
            "gate": torch.zeros((), dtype=torch.float32, device=dev),
            "ln2": init_norm(cfg.norm_type, d, dev),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype)}


def _memory_kv(p_attn: Params, mem: torch.Tensor, cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    """Project a memory [B, M, D] to K and V once (every query of the
    layer attends them); under tensor parallelism over the heads the
    rank's KV heads."""
    B, M, _ = mem.shape
    spec = _attn_spec(cfg)
    if spec.tp is not None:
        mem = spec.tp.copy_to(mem)
    wk, wv = kv_weights(p_attn, spec)
    return {"k": (mem @ wk).reshape(B, M, spec.n_kv, cfg.hd),
            "v": (mem @ wv).reshape(B, M, spec.n_kv, cfg.hd)}


def _padded_memory(x: torch.Tensor, cfg: ModelConfig, xcfg: ExchangeConfig):
    """A memory input [B, M0, D] padded to ``M = pad_len(M0, P, L)`` →
    (this rank's block of it (the whole of it without a seq group), in
    ``cfg``'s dtype; the block's first global position; the global key
    mask [B, M], False on the padding)."""
    B, M0, _ = x.shape
    M = pad_len(M0, xcfg.seq_shards, xcfg.L)
    mask = (torch.arange(M, device=x.device) < M0)[None].expand(B, M)
    _, start, m = _shard(xcfg, M)
    x = torch.nn.functional.pad(x.to(cfg.torch_dtype), (0, 0, 0, M - M0))
    return x[:, start:start + m], start, mask


def _encode_audio(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, xcfg: ExchangeConfig):
    """whisper's encoder over the stub frame embeddings ``batch["frames"]``
    [B, M0, D], padded → (this rank's block of the encoded memory, the
    global mask).  Non-causal self-attention under the plan's exchange at
    the block's global positions, with no key mask: the encoder attends
    its own padded frames, as the JAX package's does."""
    mem, start, mask = _padded_memory(batch["frames"], cfg, xcfg)
    pos = _positions(mem.shape[0], mem.shape[1], mem.device, start)
    spec = _attn_spec(cfg, causal=False)
    group = seq_group_for(xcfg) if partitioned(xcfg) else None
    for lp in params["enc_layers"]:
        mem = remat.layer(_apply_attn_mlp, lp, mem, cfg, xcfg, spec, pos,
                          group=_taped(group))
    return apply_norm(cfg.norm_type, remat.gathered(params["enc_norm"]),
                      mem), mask


def _image_memory(batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  xcfg: ExchangeConfig):
    """The stub image-patch embeddings ``batch["image_embeds"]`` [B, T0,
    D], padded → (this rank's block, the global mask)."""
    mem, _, mask = _padded_memory(batch["image_embeds"], cfg, xcfg)
    return mem, mask


def _memory(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, xcfg: ExchangeConfig):
    if cfg.family == "audio":
        return _encode_audio(params, batch, cfg, xcfg)
    return _image_memory(batch, cfg, xcfg)


def _memory_layers(params: Params, cfg: ModelConfig) -> List[Params]:
    """The layers that attend the memory, one ``mem_kv`` entry each."""
    return params["dec_layers" if cfg.family == "audio" else "cross_layers"]


def prefill_memory(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, xcfg: ExchangeConfig, cache: Params
                   ) -> Params:
    """Fill the decode cache's memory slots (audio / vlm; other families'
    caches come back as they are): ``mem_kv``, every cross layer's K and V
    of this rank's memory block stacked over the layers, and the global
    ``mem_mask``."""
    if cfg.family not in MEMORY_FAMILIES:
        return cache
    mem, mask = _memory(params, batch, cfg, xcfg)
    # a pass of its own, outside the decoder's layers: on a ZeRO-3 mesh
    # each cross layer's K/V projections are gathered for it (once a
    # request; the cache then serves every step)
    kvs = [_memory_kv(remat.gathered({n: lp["xattn"][n]
                                      for n in ("wk", "wv")}), mem, cfg)
           for lp in _memory_layers(params, cfg)]
    cache["mem_kv"] = {n: torch.stack([kv[n] for kv in kvs])
                       for n in ("k", "v")}
    cache["mem_mask"] = mask
    return cache


def _cross_attend(p: Params, x, mem_kv: Dict[str, torch.Tensor], mem_mask,
                  cfg: ModelConfig, xcfg: ExchangeConfig, decode: bool):
    """x + the cross-attention of x onto the memory's K and V (this rank's
    block) under the global ``mem_mask`` [B, M].

    Full-sequence queries go through ``exchange_cross_attention`` (across
    ranks: the rank's text partition over its memory block); a decode
    step's one token (``decode``) through ``decode_attention_sharded``
    over the ``valid`` real memory tokens (the padding is a suffix), the
    exact merge across ranks (the plan's own config without a seq group).
    A layer with a ``gate`` scales its output by ``tanh(gate)``."""
    B, N, _ = x.shape
    spec = _attn_spec(cfg)
    xin = apply_norm(cfg.norm_type, p["ln1"], x)
    if spec.tp is not None:
        xin = spec.tp.copy_to(xin)
    q = (xin @ p["xattn"]["wq"]).reshape(B, N, spec.n_heads, cfg.hd)
    k, v = mem_kv["k"], mem_kv["v"]
    kw = dict(logit_softcap=cfg.attn_softcap, scale=cfg.query_scale)
    if decode:
        dcfg = (xcfg.with_mode(ExchangeMode.VOLTAGE) if partitioned(xcfg)
                else xcfg)
        valid = mem_mask.sum(dim=-1)
        out = decode_attention_sharded(q, k, v, valid, dcfg, **kw)
    else:
        if partitioned(xcfg):   # this rank's block's mask, dense and aligned
            lo = seq_group_for(xcfg).rank * k.shape[1]
            mem_mask = mem_mask[:, lo:lo + k.shape[1]].clone(
                memory_format=torch.contiguous_format)
        out = exchange_cross_attention(q, k, v, mem_mask, xcfg, **kw)
    out = attention_output(p["xattn"], out, spec)
    if "gate" in p:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return x + out


def _cross_block(p: Params, x, mem_kv, mem_mask, cfg: ModelConfig,
                 xcfg: ExchangeConfig, decode: bool):
    """Cross-attention, then x + mlp(ln2(x))."""
    x = _cross_attend(p, x, mem_kv, mem_mask, cfg, xcfg, decode)
    return x + _mlp(p["mlp"], apply_norm(cfg.norm_type, p["ln2"], x), cfg,
                    cfg.d_ff)


def _cached_kv(cache: Params, i: int) -> Dict[str, torch.Tensor]:
    """Memory layer ``i``'s K and V from the cache's ``mem_kv``."""
    mem = cache["mem_kv"]
    if mem is None:
        raise ValueError("the decode cache holds no memory: call "
                         "prefill_memory first")
    return {"k": mem["k"][i], "v": mem["v"][i]}


# ---------------------------------------------------------------------------
# hybrid (hymba: attention ‖ Mamba heads) and ssm (xLSTM)
# ---------------------------------------------------------------------------

def _init_hymba_layer(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Attention and a Mamba mixer side by side; ``fuse`` is None, as in
    the JAX package at ``n_heads · hd == d``, the only width either runs."""
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    return {"ln1": init_norm(cfg.norm_type, d, dev),
            "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, dtype),
            "mamba": ssm_mod.init_mamba(gen, d, cfg.ssm, dtype),
            "attn_norm": init_norm(cfg.norm_type, cfg.n_heads * cfg.hd, dev),
            "ssm_norm": init_norm(cfg.norm_type, d, dev),
            "fuse": None,
            "ln2": init_norm(cfg.norm_type, d, dev),
            "mlp": init_mlp(gen, d, cfg.d_ff, dtype)}


def _hymba_mix(p: Params, attn_out: torch.Tensor, ssm_out: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """hymba's fusion (arXiv:2411.13676): each path normed, then their
    mean."""
    a = apply_norm(cfg.norm_type, p["attn_norm"], attn_out)
    s = apply_norm(cfg.norm_type, p["ssm_norm"], ssm_out)
    return 0.5 * (a + s)


def _width(split, whole: Optional[int] = None) -> Optional[int]:
    """A mixer's channels on this rank: its split's, or ``whole``."""
    return whole if split is None else split.hi - split.lo


def _mamba_like(x: torch.Tensor, cfg: ModelConfig):
    return ssm_mod.init_mamba_state(
        x.shape[0], cfg.d_model, cfg.ssm, x.dtype,
        d_inner=_width(tpm.mixer(cfg, "mamba")), device="meta")


def _apply_hymba_layer(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                       positions, group=None):
    """Attention under the plan's exchange and the Mamba scan (across a
    seq group: from the state the rank before ended with) over the same
    normed input, mixed, then the MLP.  Under tensor parallelism the Mamba
    runs the rank's channels (``tp.mixer``) and its output is the row's
    sum, which the mix norms as it is."""
    tp = tpm.mixer(cfg, "mamba")
    xin = apply_norm(cfg.norm_type, p["ln1"], x)
    q, k, v = project_qkv(p["attn"], xin, spec, positions)
    heads = exchange_attention(q, k, v, xcfg, causal=spec.causal,
                               window=spec.window,
                               logit_softcap=spec.logit_softcap,
                               scale=spec.scale)
    attn_out = attention_output(p["attn"], heads, spec)
    ssm_out = handoff_scan(
        group, lambda st: ssm_mod.mamba_scan(
            p["mamba"], xin, cfg.ssm, *((None, None) if st is None
                                        else (st["h"], st["conv"])), tp=tp),
        lambda: _mamba_like(xin, cfg), xin.device, anchor=xin)
    x = x + _hymba_mix(p, attn_out, ssm_out, cfg)
    return x + _mlp(p["mlp"], apply_norm(cfg.norm_type, p["ln2"], x), cfg,
                    cfg.d_ff)


def _store(views: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
    """Write a new recurrent state into its slice of the stacked cache."""
    for name, t in views.items():
        t.copy_(new[name])


def _apply_hymba_decode(p: Params, x, cfg: ModelConfig, xcfg, spec: AttnSpec,
                        kv, state, index):
    xin = apply_norm(cfg.norm_type, p["ln1"], x)
    attn_out, _ = attention_decode(p["attn"], xin, spec, xcfg, kv, index)
    ssm_out, new = ssm_mod.mamba_step(p["mamba"], xin, cfg.ssm, state,
                                      tp=tpm.mixer(cfg, "mamba"))
    _store(state, new)
    x = x + _hymba_mix(p, attn_out, ssm_out, cfg)
    return x + _mlp(p["mlp"], apply_norm(cfg.norm_type, p["ln2"], x), cfg,
                    cfg.d_ff)


def _init_xlstm_group(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """One group: ``slstm_every − 1`` mLSTM blocks (each with its own
    norm), then one sLSTM block."""
    d, dtype, dev = cfg.d_model, cfg.torch_dtype, gen.device
    n_m = cfg.ssm.slstm_every - 1
    return {"m_ln": [init_norm(cfg.norm_type, d, dev) for _ in range(n_m)],
            "mlstm": [ssm_mod.init_mlstm(gen, d, cfg.ssm, dtype)
                      for _ in range(n_m)],
            "s_ln": init_norm(cfg.norm_type, d, dev),
            "slstm": ssm_mod.init_slstm(gen, d, cfg.ssm, dtype)}


def _apply_xlstm_group(p: Params, x, cfg: ModelConfig, group=None):
    """The group over the whole sequence (across a seq group each block
    starts from the state the rank before ended with; under tensor
    parallelism each block runs the rank's channels, ``tp.mixer``)."""
    B, dev = x.shape[0], x.device
    tm, ts = tpm.mixer(cfg, "mlstm"), tpm.mixer(cfg, "slstm")
    for ln, lp in zip(p["m_ln"], p["mlstm"]):
        xin = apply_norm(cfg.norm_type, ln, x)
        x = x + handoff_scan(
            group, lambda st: ssm_mod.mlstm_scan(lp, xin, cfg.ssm, st, tm),
            lambda: ssm_mod.init_mlstm_state(B, cfg.d_model, cfg.ssm,
                                             device="meta",
                                             values=_width(tm)),
            dev, anchor=xin)
    xin = apply_norm(cfg.norm_type, p["s_ln"], x)
    return x + handoff_scan(
        group, lambda st: ssm_mod.slstm_scan(p["slstm"], xin, cfg.ssm, st,
                                             ts),
        lambda: ssm_mod.init_slstm_state(B, _width(ts, cfg.d_model),
                                         device="meta"), dev, anchor=xin)


def _apply_xlstm_decode(p: Params, x, cfg: ModelConfig, m_states, s_state):
    """One token through the group; ``m_states`` holds the mLSTM blocks'
    states stacked ``[n_m, B, ...]``, ``s_state`` the sLSTM's (views into
    the cache, updated in place; under tensor parallelism the rank's
    channels)."""
    tm, ts = tpm.mixer(cfg, "mlstm"), tpm.mixer(cfg, "slstm")
    for j, (ln, lp) in enumerate(zip(p["m_ln"], p["mlstm"])):
        st = {name: t[j] for name, t in m_states.items()}
        y, new = ssm_mod.mlstm_step(lp, apply_norm(cfg.norm_type, ln, x),
                                    cfg.ssm, st, tm)
        _store(st, new)
        x = x + y
    y, new = ssm_mod.slstm_step(
        p["slstm"], apply_norm(cfg.norm_type, p["s_ln"], x), cfg.ssm,
        s_state, ts)
    _store(s_state, new)
    return x + y


def _recurrent_cache(cfg: ModelConfig, batch: int, device) -> Params:
    """The recurrent halves of the decode cache: hybrid's ``ssm`` (every
    layer's Mamba state), ssm's ``m`` and ``s`` (every group's mLSTM and
    sLSTM states); {} for the attention families.  Under tensor
    parallelism (``tp.mixer``) each holds the rank's channels."""
    def stack(state, *lead):
        return {name: t.expand(*lead, *t.shape).clone()
                for name, t in state.items()}
    if cfg.family == "hybrid":
        return {"ssm": stack(ssm_mod.init_mamba_state(
            batch, cfg.d_model, cfg.ssm, cfg.torch_dtype,
            d_inner=_width(tpm.mixer(cfg, "mamba")), device=device),
            cfg.n_layers)}
    if cfg.family == "ssm":
        G, n_m = cfg.n_layers // cfg.ssm.slstm_every, cfg.ssm.slstm_every - 1
        return {"m": stack(ssm_mod.init_mlstm_state(
                    batch, cfg.d_model, cfg.ssm, device=device,
                    values=_width(tpm.mixer(cfg, "mlstm"))), G, n_m),
                "s": stack(ssm_mod.init_slstm_state(
                    batch, _width(tpm.mixer(cfg, "slstm"), cfg.d_model),
                    device=device), G)}
    return {}


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

class Stack(NamedTuple):
    """One layer stack of ``layer_stacks``."""
    name: str                   # the params list
    half: Optional[str]         # its KV half of the decode cache, or None
    depth: int
    window: Optional[int]       # attention window
    lead: int                   # lead axes holding the layers in the JAX
                                # package's stacked layout
    inner: Dict[str, int] = {}  # keys of a layer that are stacks of their
                                # own (one lead axis more there) → depth


def layer_stacks(cfg: ModelConfig) -> List[Stack]:
    """The model's layer stacks in walk order: ``layers`` over ``kv``,
    gemma2's ``local_layers`` (the sliding window) over ``local`` and
    ``global_layers`` over ``global``, ``n_layers // 2`` each, or the moe
    family's ``first_layers`` (dense MLPs) over ``first`` and then
    ``layers`` (experts) over ``kv``; audio's ``enc_layers`` (no cache)
    and ``dec_layers`` over ``kv``; vlm's ``self_layers`` (every group's
    dense layers, group by group: two lead axes, ``[n_groups,
    cross_attn_every − 1, ...]``) over ``self`` and ``cross_layers`` (no
    self-attention cache: their memory K/V is ``mem_kv``); hybrid's
    ``layers`` over ``kv`` (its Mamba states are the cache's ``ssm``);
    ssm's ``groups`` (no KV cache; their states are ``m`` and ``s``), whose
    ``mlstm`` and ``m_ln`` are stacks of ``slstm_every − 1`` of their own
    (``[groups, slstm_every − 1, ...]`` in the JAX package)."""
    if cfg.family == "moe":
        fd = cfg.moe.first_dense_layers
        return [Stack("first_layers", "first", fd, None, 1),
                Stack("layers", "kv", cfg.n_layers - fd, None, 1)]
    if cfg.family == "audio":
        return [Stack("enc_layers", None, cfg.encoder_layers, None, 1),
                Stack("dec_layers", "kv", cfg.n_layers, None, 1)]
    if cfg.family == "vlm":
        n = cfg.n_layers // cfg.cross_attn_every
        return [Stack("self_layers", "self", n * (cfg.cross_attn_every - 1),
                      None, 2),
                Stack("cross_layers", None, n, None, 1)]
    if cfg.family == "ssm":
        n_m = cfg.ssm.slstm_every - 1
        return [Stack("groups", None, cfg.n_layers // cfg.ssm.slstm_every,
                      None, 1, {"mlstm": n_m, "m_ln": n_m})]
    if cfg.local_global:
        n = cfg.n_layers // 2
        return [Stack("local_layers", "local", n, cfg.window, 1),
                Stack("global_layers", "global", n, None, 1)]
    return [Stack("layers", "kv", cfg.n_layers, None, 1)]


def init_lm(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Decoder parameters drawn from ``gen`` on its device."""
    _require_ported(cfg)
    d, dtype = cfg.d_model, cfg.torch_dtype
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, d, dtype),
        "final_norm": init_norm(cfg.norm_type, d, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab_size, d, dtype)
    init = {"first_layers": lambda: _init_moe_layer(cfg, gen, True),
            "dec_layers": lambda: _init_encdec_layer(cfg, gen),
            "cross_layers": lambda: _init_cross_layer(cfg, gen),
            "groups": lambda: _init_xlstm_group(cfg, gen)}
    if cfg.family == "moe":
        init["layers"] = lambda: _init_moe_layer(cfg, gen, False)
    if cfg.family == "hybrid":
        init["layers"] = lambda: _init_hymba_layer(cfg, gen)
    for st in layer_stacks(cfg):
        params[st.name] = [
            init.get(st.name, lambda: _init_dense_layer(cfg, gen))()
            for _ in range(st.depth)]
    if cfg.family == "audio":
        params["enc_norm"] = init_norm(cfg.norm_type, d, gen.device)
    return params


def _walk(params: Params, cfg: ModelConfig):
    """Every decoder layer in order → (its params, its attention spec, its
    cache half, its index in that half).  gemma2 alternates: local layer
    i (the sliding window), then global layer i; the moe family walks its
    stacks one after the other.  A layer that attends the memory comes
    with the half ``MEMORY`` and the index of its K and V in ``mem_kv``:
    whisper's decoder layer i as its self-attention (params without an
    MLP) and then its cross-attention and MLP; the vlm's cross layer of
    group g after the group's dense layers.  An xLSTM group comes whole,
    with no cache half (its states are the cache's ``m`` and ``s``)."""
    spec = _attn_spec(cfg)
    if cfg.family == "audio":
        return [e for i, lp in enumerate(params["dec_layers"])
                for e in (({"ln1": lp["ln1"], "attn": lp["attn"]}, spec,
                           "kv", i),
                          ({"ln1": lp["ln_x"], "xattn": lp["xattn"],
                            "ln2": lp["ln2"], "mlp": lp["mlp"]}, spec,
                           MEMORY, i))]
    if cfg.family == "vlm":
        k = cfg.cross_attn_every - 1
        return [e for g, cp in enumerate(params["cross_layers"])
                for e in [(params["self_layers"][j], spec, "self", j)
                          for j in range(g * k, (g + 1) * k)]
                + [(cp, spec, MEMORY, g)]]
    stacks = [(params[st.name], _attn_spec(cfg, window=st.window), st.half)
              for st in layer_stacks(cfg)]
    if cfg.family == "moe":
        return [(lp, spec, half, i) for lps, spec, half in stacks
                for i, lp in enumerate(lps)]
    return [(lps[i], spec, half, i)
            for i in range(len(stacks[0][0]))
            for lps, spec, half in stacks]


def _head(params: Params, cfg: ModelConfig) -> Params:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def _embed(params: Params, tokens, cfg: ModelConfig):
    """The token embeddings (vocab-parallel where ``tp.vocab`` says)."""
    return embed(remat.gathered(params["embed"]), tokens,
                 scale_by_sqrt_d=cfg.embed_scale,
                 tp=tpm.vocab(cfg.vocab_size))


def _final_norm(params: Params, x, cfg: ModelConfig) -> torch.Tensor:
    return apply_norm(cfg.norm_type, remat.gathered(params["final_norm"]), x)


def _logits(params: Params, x, cfg: ModelConfig, columns: bool = False
            ) -> torch.Tensor:
    """The f32 logits of the normed ``x`` over the whole vocabulary: a
    vocab-parallel unembedding's columns gathered over the row, or with
    ``columns`` the rank's V/M columns only (the train loss combines the
    row's log-sum-exps and gold logits, ``train_step.loss_fn``)."""
    tp = tpm.vocab(cfg.vocab_size)
    logits = unembed(remat.gathered(_head(params, cfg)), x,
                     final_softcap=cfg.final_softcap, tp=tp)
    return logits if tp is None or columns else tp.gather_from(logits)


def _positions(B: int, N: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + N, dtype=torch.int32,
                        device=device)[None].expand(B, N)


def _shard(xcfg: ExchangeConfig, N: int):
    """This rank's part of an N-token sequence → (seq group or None, first
    global position, length).  A partitioned plan needs ``N % P == 0``
    and, for PRISM with its segment means, each part to split into L equal
    segments — the layouts the JAX package's ``shard_map`` accepts (a
    PRISM plan with another codec exchanges whole partitions and needs no
    L)."""
    if not partitioned(xcfg):
        return None, 0, N
    P = xcfg.seq_shards
    if N % P:
        raise ValueError(f"{N} tokens do not split into {P} sequence "
                         f"partitions")
    Np = N // P
    means = xcfg.codec in ("", "segment_means")
    if xcfg.mode == ExchangeMode.PRISM and means and (xcfg.L <= 0
                                                      or Np % xcfg.L):
        raise ValueError(f"a partition of {Np} tokens does not split into "
                         f"L={xcfg.L} segment means")
    group = seq_group_for(xcfg)
    return group, group.rank * Np, Np


def _last_logits(params: Params, x, cfg: ModelConfig, group):
    """Logits of the sequence's last position [B, 1, V] f32 on every rank:
    it lies on the last rank of a seq group, which broadcasts them.  Under
    autograd every rank unembeds its own last position (the others'
    values are dropped), so the broadcast's backward, which sums the
    cotangents onto the last rank, runs on every rank."""
    last = group is None or group.rank == group.world_size - 1
    # every rank gathers the head (a mesh's gathers are collectives)
    head = "embed" if cfg.tie_embeddings else "lm_head"
    params = {**params, **remat.gathered(
        {k: params[k] for k in (head, "final_norm")})}
    if last or (torch.is_grad_enabled() and x.requires_grad):
        logits = _logits(params, _final_norm(params, x[:, -1:], cfg), cfg)
    else:
        logits = torch.empty((x.shape[0], 1, cfg.vocab_size),
                             dtype=torch.float32, device=x.device)
    if group is None:
        return logits
    return group.broadcast(logits, src=group.world_size - 1)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _decoder_layer(lp: Params, spec: AttnSpec, half, x, cfg: ModelConfig,
                   xcfg: ExchangeConfig, positions, group, mem, mem_mask,
                   decode: bool):
    """One entry of ``_walk`` over the full sequence → (x, the moe
    layer's aux or None); ``forward_lm`` rematerialises each under grad
    (``remat.region``)."""
    if half == MEMORY:
        return _cross_block(lp, x, _memory_kv(lp["xattn"], mem, cfg),
                            mem_mask, cfg, xcfg, decode=decode), None
    if cfg.family == "moe":
        return _apply_moe_layer(lp, x, cfg, xcfg, spec, positions, group)
    if cfg.family == "hybrid":
        return _apply_hymba_layer(lp, x, cfg, xcfg, spec, positions,
                                  group), None
    if cfg.family == "ssm":
        return _apply_xlstm_group(lp, x, cfg, group), None
    return _apply_attn_mlp(lp, x, cfg, xcfg, spec, positions), None


def forward_lm(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, xcfg: ExchangeConfig,
               last_only: bool = False, local_logits: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: {"tokens": [B, N]}, and audio's
    ``"frames"`` [B, M0, D] or vlm's ``"image_embeds"`` [B, M0, D] → (logits
    [B, N, V] f32, aux scalar).  ``last_only`` unembeds just the final
    position (logits [B, 1, V]).  Under a partitioned plan each rank runs
    its part of the sequence (and of the memory) and every rank returns
    the global logits, or with ``local_logits`` only its own part's
    ``[B, N/P, V]`` (the train step's loss reads its own tokens, and no
    logits cross ranks); under a vocab-parallel head (``tp.vocab``)
    ``local_logits`` keeps the rank's ``[B, N, V/M]`` columns.  ``aux`` is
    the moe family's summed load-balance loss (0 otherwise).  Each layer
    reads its weights through ``remat.gathered`` inside its region
    (``remat.layer``), as do the embedding, the final norm and the head."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, N = tokens.shape
    group, start, n = _shard(xcfg, N)
    tokens = tokens[:, start:start + n]
    x = _embed(params, tokens, cfg)
    positions = _positions(B, n, tokens.device, start)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    mem = mem_mask = None
    if cfg.family in MEMORY_FAMILIES:
        mem, mem_mask = _memory(params, batch, cfg, xcfg)
    for lp, spec, half, _ in _walk(params, cfg):
        x, a = remat.layer(_decoder_layer, lp, spec, half, x, cfg, xcfg,
                           positions, group, mem, mem_mask, N == 1,
                           group=_taped(group))
        if a is not None:
            aux = aux + a
    if last_only:
        return _last_logits(params, x, cfg, group), aux
    logits = _logits(params, _final_norm(params, x, cfg), cfg,
                     columns=local_logits)
    if group is not None and not local_logits:   # [P, B, Np, V] → [B, N, V]
        logits = group.all_gather(logits, kind="output")
        logits = logits.permute(1, 0, 2, 3).reshape(B, N, -1)
    return logits, aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, seq: int,
                      device=None, xcfg: Optional[ExchangeConfig] = None
                      ) -> Params:
    """Cache dict with a stacked leading layer dim (the JAX layout), one
    half a stack of ``layer_stacks``: ``{"kv": ...}`` over the layers,
    gemma2's ``{"local": ..., "global": ...}`` over the pairs, or the moe
    family's ``{"first": ..., "kv": ...}`` (MLA: the latent ``c_kv`` and
    ``k_pe`` leaves); audio's ``{"kv": ...}`` and vlm's ``{"self": ...}``
    with empty ``mem_kv`` and ``mem_mask`` slots (``prefill_memory`` fills
    them); hybrid's ``{"kv": ..., "ssm": ...}`` and ssm's ``{"m": ...,
    "s": ...}`` recurrent states (f32; the Mamba conv tail in the model
    dtype).  Under a partitioned ``xcfg`` every KV half is this rank's
    block of ``ceil(seq / P)`` positions: the cache rounds up to a
    multiple of P, and the padded slots are never valid; every rank holds
    the whole recurrent state.  Under tensor parallelism over the heads
    (``tp.heads``) a rank holds the KV heads its query heads read (one
    shared with other ranks where the KV heads are fewer), and the
    recurrent states of its mixers' channels (``tp.mixer``): a layout
    choice (the JAX plan leaves the cache replicated, and GSPMD computes
    the attention head-sharded from it)."""
    _require_ported(cfg)
    if xcfg is not None and partitioned(xcfg):
        seq = -(-seq // xcfg.seq_shards)
    halves = [(st.half, st.depth) for st in layer_stacks(cfg)
              if st.half is not None]
    cache = {}
    if halves:
        if cfg.mla is not None:
            c = mla_mod.init_mla_cache(batch, seq, cfg.mla, cfg.torch_dtype,
                                       device=device)
        else:
            c = init_kv_cache(batch, seq, _attn_spec(cfg).n_kv, cfg.hd,
                              cfg.torch_dtype, quant=cfg.kv_quant,
                              device=device)
        cache = {half: {name: t[None].repeat(n, *([1] * t.ndim))
                        for name, t in c.items()} for half, n in halves}
    cache.update(_recurrent_cache(cfg, batch, device))
    if cfg.family in MEMORY_FAMILIES:
        cache.update(mem_kv=None, mem_mask=None)
    return cache


def _layer_cache(cache: Params, half: str, i: int
                 ) -> Dict[str, torch.Tensor]:
    """Views of layer ``i``'s slice of the stacked cache half ``half``
    (writes land in the stacked tensors)."""
    return {name: t[i] for name, t in cache[half].items()}


def decode_step(params: Params, batch: Dict[str, torch.Tensor], cache: Params,
                cache_index, cfg: ModelConfig, xcfg: ExchangeConfig
                ) -> Tuple[torch.Tensor, Params]:
    """One-token step. batch: {"tokens": [B, 1]} → (logits [B, 1, V],
    cache updated in place). ``cache_index`` is the write position: an int
    for every row, or a ``[B]`` int tensor, one position per row (see
    ``layers.attention_decode``).  audio and vlm attend the memory that
    ``prefill_memory`` put in the cache."""
    _require_ported(cfg)
    x = _embed(params, batch["tokens"], cfg)
    if isinstance(cache_index, torch.Tensor):      # once, not per layer
        cache_index = cache_index.to(device=x.device, dtype=torch.long)
    for lp, spec, half, i in _walk(params, cfg):
        x = _decode_layer(remat.gathered(lp), spec, half, i, x, cache,
                          cache_index, cfg, xcfg)
    return _logits(params, _final_norm(params, x, cfg), cfg), cache


def _decode_layer(lp: Params, spec: AttnSpec, half, i: int, x, cache: Params,
                  cache_index, cfg: ModelConfig, xcfg: ExchangeConfig):
    """One entry of ``_walk`` for one token (``decode_step``), its cache
    updated in place; ``lp`` as the layer runs it (gathered)."""
    if half == MEMORY:
        return _cross_block(lp, x, _cached_kv(cache, i), cache["mem_mask"],
                            cfg, xcfg, decode=True)
    if cfg.family == "hybrid":
        return _apply_hymba_decode(lp, x, cfg, xcfg, spec,
                                   _layer_cache(cache, half, i),
                                   _layer_cache(cache, "ssm", i),
                                   cache_index)
    if cfg.family == "ssm":
        return _apply_xlstm_decode(lp, x, cfg, _layer_cache(cache, "m", i),
                                   _layer_cache(cache, "s", i))
    layer = _apply_moe_decode if cfg.family == "moe" else \
        _apply_attn_mlp_decode
    return layer(lp, x, cfg, xcfg, spec, _layer_cache(cache, half, i),
                 cache_index)


def supports_page_pool(cfg: ModelConfig) -> bool:
    """Paged decode covers the plain dense stack: one homogeneous KV cache
    per layer, no sliding-window alternation and no per-slot int8 cache
    (cold pages quantize through the transport codecs instead, in
    ``repro_torch.serving.pages``)."""
    return (cfg.family == "dense" and not cfg.local_global
            and not cfg.kv_quant)


def init_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                   device=None) -> Params:
    """Shared paged KV pool: the ``init_decode_cache`` dict with the
    (batch, seq) axes read as (page, in-page position) — leaves are
    ``[n_layers, n_pages, page_size, Hk, dh]``.  Requests address it
    through per-row page tables; physical pages are interchangeable."""
    if not supports_page_pool(cfg):
        raise ValueError(f"family {cfg.family!r} (local_global="
                         f"{cfg.local_global}, kv_quant={cfg.kv_quant}) "
                         f"has no paged decode path")
    return init_decode_cache(cfg, n_pages, page_size, device=device)


def decode_step_paged(params: Params, batch: Dict[str, torch.Tensor],
                      pool: Params, page_table: torch.Tensor,
                      lengths: torch.Tensor, cfg: ModelConfig,
                      xcfg: ExchangeConfig) -> Tuple[torch.Tensor, Params]:
    """One-token step for every row against the shared paged pool.

    batch: {"tokens": [S, 1]}; ``page_table`` [S, max_pages] int32 maps each
    row's logical blocks to pool pages; ``lengths`` [S] is each row's
    current sequence length (= this step's write position).  Returns
    (logits [S, 1, V], the pool, updated in place)."""
    if not supports_page_pool(cfg):
        raise ValueError(f"family {cfg.family!r} has no paged decode path")
    x = embed(params["embed"], batch["tokens"],
              scale_by_sqrt_d=cfg.embed_scale)
    # once, not per layer
    page_table = page_table.to(device=x.device, dtype=torch.int32)
    lengths = lengths.to(device=x.device, dtype=torch.long)
    spec = _attn_spec(cfg)
    for i, lp in enumerate(params["layers"]):
        x = _apply_attn_mlp_decode_paged(lp, x, cfg, xcfg, spec,
                                         _layer_cache(pool, "kv", i),
                                         page_table, lengths)
    x = apply_norm(cfg.norm_type, params["final_norm"], x)
    logits = unembed(_head(params, cfg), x, final_softcap=cfg.final_softcap)
    return logits, pool


def supports_prefill(cfg: ModelConfig) -> bool:
    return cfg.family in PREFILL_FAMILIES


def prefill(params: Params, batch: Dict[str, torch.Tensor], cache: Params,
            cfg: ModelConfig, xcfg: ExchangeConfig
            ) -> Tuple[torch.Tensor, Params]:
    """Single-pass prefill: run the prompt [B, T0] through
    ``exchange_attention`` once and write the KV cache for positions
    [0, T0) → (last-position logits [B, 1, V] f32, primed cache).  Under a
    partitioned plan each rank runs its part of the prompt and fills its
    cache block; PRISM's prompt then attends through segment means (the
    paper's distributed prefill), which is not T0 exact decode steps.
    audio and vlm attend the memory that ``prefill_memory`` put in the
    cache."""
    if not supports_prefill(cfg):
        raise ValueError(f"family {cfg.family!r} has no single-pass "
                         f"prefill; use the decode-loop prefill "
                         f"(repro_torch.api.generation.prefill_by_decode)")
    _require_ported(cfg)
    tokens = batch["tokens"]
    B, T0 = tokens.shape
    group, start, n = _shard(xcfg, T0)
    tokens = tokens[:, start:start + n]
    x = _embed(params, tokens, cfg)
    positions = _positions(B, n, tokens.device, start)
    for lp, spec, half, i in _walk(params, cfg):
        x = _prefill_layer(remat.gathered(lp), spec, half, i, x, cache,
                           positions, group, cfg, xcfg, T0 == 1)
    return _last_logits(params, x, cfg, group), cache


def _prefill_layer(lp: Params, spec: AttnSpec, half, i: int, x, cache: Params,
                   positions, group, cfg: ModelConfig, xcfg: ExchangeConfig,
                   one: bool):
    """One entry of ``_walk`` over the prompt (``prefill``), its cache
    written; ``lp`` as the layer runs it (gathered)."""
    if half == MEMORY:
        return _cross_block(lp, x, _cached_kv(cache, i), cache["mem_mask"],
                            cfg, xcfg, decode=one)
    c = _layer_cache(cache, half, i)
    if cfg.family == "moe":
        return _apply_moe_prefill(lp, x, cfg, xcfg, spec, positions, c, group)
    h = _attn_prefill(lp, x, cfg, xcfg, spec, positions, c, group)
    return _mlp_residual(lp, x, h, cfg)
