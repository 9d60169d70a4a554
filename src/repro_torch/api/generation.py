"""Generation: prompt prefill + the autoregressive decode loop.

Port of ``repro.api.generation`` (``generate`` and its parts).  PyTorch
runs eagerly, so the JAX package's one jitted executable per shape becomes
a Python loop over ``decode_step`` with the cache updated in place; tokens
stay on the device between steps (no host round-trip per token).

* **Prefill** — ``transformer.prefill`` runs the prompt through
  ``exchange_attention`` once and writes the KV cache (``single_pass``).
  PRISM plans under ``prefill_mode="auto"`` (whose compressed prefill is
  not equivalent to exact per-token decode) use ``prefill_by_decode``: the
  teacher-forced decode loop over the prompt.
* **Decode** — ``decode_step`` plus sampling on the device: greedy is
  ``argmax`` (first index on ties, as in JAX); temperature sampling draws
  from a ``torch.Generator`` seeded from ``seed``.  It is deterministic for
  a seed but does not reproduce JAX's threefry draws.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode
from repro_torch.models import transformer as tfm


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator],
                 temperature: float = 0.0) -> torch.Tensor:
    """[B, 1, V] → [B, 1] int32 token ids (greedy at T=0)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=gen)
    return draws.reshape(logits.shape[:-1]).to(torch.int32)


def resolve_prefill_mode(cfg: ModelConfig, xcfg: ExchangeConfig,
                         mode: str = "auto") -> str:
    """Pick the prefill implementation: "single_pass" or "scan".

    "auto" chooses single-pass when the family supports it AND the
    full-sequence math is exact w.r.t. the decode path: PRISM plans (whose
    prefill goes through compressed segment means) and MoE keep the decode
    loop; pass ``prefill_mode="single_pass"`` to force the compressed
    prefill."""
    if mode == "scan":
        return "scan"
    supported = tfm.supports_prefill(cfg)
    if mode == "single_pass":
        if not supported:
            raise ValueError(f"family {cfg.family!r} has no single-pass "
                             f"prefill (supported: {tfm.PREFILL_FAMILIES})")
        return "single_pass"
    if mode != "auto":
        raise ValueError(f"prefill_mode {mode!r}: one of "
                         f"'auto' | 'single_pass' | 'scan'")
    exact = ((xcfg.mode in (ExchangeMode.LOCAL, ExchangeMode.VOLTAGE)
              or xcfg.seq_axis is None or xcfg.seq_shards == 1)
             and cfg.moe is None)
    return "single_pass" if (supported and exact) else "scan"


def prefill_by_decode(params, prompt_tokens: torch.Tensor, cache,
                      cfg: ModelConfig, xcfg: ExchangeConfig):
    """Teacher-forced prompt consumption, one ``decode_step`` per prompt
    token → (last logits [B, 1, V], primed cache)."""
    logits = None
    for t in range(prompt_tokens.shape[1]):
        logits, cache = tfm.decode_step(
            params, {"tokens": prompt_tokens[:, t:t + 1]}, cache, t, cfg,
            xcfg)
    return logits, cache


def decode_scan(params, cache, tok0: torch.Tensor, start_index: int,
                gen: Optional[torch.Generator], cfg: ModelConfig,
                xcfg: ExchangeConfig, temperature: float, n_steps: int):
    """``n_steps`` autoregressive steps from ``tok0`` [B, 1] at
    ``start_index`` → (tokens [B, n_steps] int32, cache)."""
    toks = []
    tok = tok0
    for i in range(n_steps):
        logits, cache = tfm.decode_step(params, {"tokens": tok}, cache,
                                        start_index + i, cfg, xcfg)
        tok = sample_token(logits, gen, temperature)[:, 0:1]
        toks.append(tok)
    if not toks:
        return tok0.new_zeros((tok0.shape[0], 0)), cache
    return torch.cat(toks, dim=1), cache


def build_generate_fn(cfg: ModelConfig, xcfg: ExchangeConfig, *,
                      n_new: int, temperature: float = 0.0,
                      prefill_mode: str = "auto") -> Callable:
    """End-to-end generation callable:
    ``fn(params, prompt_tokens [B, T0], extras, gen) → [B, n_new]`` —
    cache init, prefill and the sampled decode loop."""
    mode = resolve_prefill_mode(cfg, xcfg, prefill_mode)

    @torch.inference_mode()
    def gen_fn(params, prompt_tokens, extras, gen):
        B, T0 = prompt_tokens.shape
        cache = tfm.init_decode_cache(cfg, B, T0 + n_new,
                                      device=prompt_tokens.device)
        if mode == "single_pass":
            logits, cache = tfm.prefill(
                params, {"tokens": prompt_tokens, **extras}, cache, cfg,
                xcfg)
        else:
            logits, cache = prefill_by_decode(params, prompt_tokens, cache,
                                              cfg, xcfg)
        tok = sample_token(logits, gen, temperature)[:, 0:1]
        rest, _ = decode_scan(params, cache, tok, T0, gen, cfg, xcfg,
                              temperature, n_new - 1)
        return torch.cat([tok, rest], dim=1)

    gen_fn.prefill_mode = mode
    return gen_fn


def generate(params, prompt_tokens: torch.Tensor, n_new: int,
             cfg: ModelConfig, xcfg: ExchangeConfig, *,
             batch_extras: Optional[Dict[str, Any]] = None, seed: int = 0,
             temperature: float = 0.0,
             prefill_mode: str = "auto") -> torch.Tensor:
    """One-shot generation: prompt [B, T0] → [B, n_new] int32 tokens."""
    B = prompt_tokens.shape[0]
    if n_new <= 0:
        return torch.zeros((B, 0), dtype=torch.int32,
                           device=prompt_tokens.device)
    fn = build_generate_fn(cfg, xcfg, n_new=n_new, temperature=temperature,
                           prefill_mode=prefill_mode)
    gen = torch.Generator(device=prompt_tokens.device)
    gen.manual_seed(seed)
    return fn(params, prompt_tokens, dict(batch_extras or {}), gen)
