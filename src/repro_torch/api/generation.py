"""Generation: prompt prefill + the autoregressive decode loop.

Port of ``repro.api.generation`` (``generate`` and its parts).  PyTorch
runs eagerly, so the JAX package's one jitted executable per shape becomes
a Python loop over ``decode_step`` with the cache updated in place; tokens
stay on the device between steps (no host round-trip per token).

* **Prefill** — audio and vlm first fill the cache's memory from the
  request's ``frames`` or ``image_embeds`` (``transformer.prefill_memory``:
  whisper's encoder, the cross layers' K/V).  ``transformer.prefill`` runs
  the prompt through ``exchange_attention`` once and writes the KV cache
  (``single_pass``).
  PRISM plans under ``prefill_mode="auto"`` (whose compressed prefill is
  not equivalent to exact per-token decode) use ``prefill_by_decode``: the
  teacher-forced decode loop over the prompt.
* **Decode** — ``decode_step`` plus sampling on the device: greedy is
  ``argmax`` (first index on ties, as in JAX); temperature sampling draws
  from a ``torch.Generator`` seeded from ``seed``.  It is deterministic for
  a seed but does not reproduce JAX's threefry draws.
* **Partitioned plans** — under ``voltage`` / ``prism`` every rank of the
  seq group runs the same call: the cache is sharded along S, every rank
  gets bitwise the same logits from the exact merge, and identically
  seeded generators draw the same tokens on every rank.
* **Serving primitives** — the slot-pool and paged-pool builders of the
  serving runtime (``repro_torch.serving``): plain functions that update
  the pool in place (the JAX package donates it to a jitted executable),
  with Python loops in place of ``lax.scan``.  Both pools hold one
  partition, as the JAX package's slot pool is not mesh-sharded; their
  builders refuse a partitioned plan.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exchange import ExchangeConfig, ExchangeMode, partitioned
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


def prefill_prompt(params, prompt_tokens: torch.Tensor, extras, cache,
                   cfg: ModelConfig, xcfg: ExchangeConfig, mode: str):
    """The request's memory (audio, vlm: from ``extras``), then the prompt
    prefill by ``mode`` (``resolve_prefill_mode``'s "single_pass" or
    "scan") → (last logits [B, 1, V], primed cache)."""
    cache = tfm.prefill_memory(params, {"tokens": prompt_tokens, **extras},
                               cfg, xcfg, cache)
    if mode == "single_pass":
        return tfm.prefill(params, {"tokens": prompt_tokens, **extras},
                           cache, cfg, xcfg)
    return prefill_by_decode(params, prompt_tokens, cache, cfg, xcfg)


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
                                      device=prompt_tokens.device, xcfg=xcfg)
        logits, cache = prefill_prompt(params, prompt_tokens, extras, cache,
                                       cfg, xcfg, mode)
        tok = sample_token(logits, gen, temperature)[:, 0:1]
        rest, _ = decode_scan(params, cache, tok, T0, gen, cfg, xcfg,
                              temperature, n_new - 1)
        return torch.cat([tok, rest], dim=1)

    gen_fn.prefill_mode = mode
    return gen_fn


# ---------------------------------------------------------------------------
# slot-pool serving primitives (continuous batching)
# ---------------------------------------------------------------------------
#
# The serving runtime keeps ONE pooled decode cache with a slot per
# in-flight request; requests are admitted into free slots between decode
# chunks.  Per-slot state: the current token [S] and write position [S] on
# the device, and on the host each slot's temperature and its request's own
# ``torch.Generator``.  A slot then draws exactly the numbers a B=1
# ``generate`` with the request's seed draws (one ``multinomial`` per
# sampled token, none when greedy), so its tokens do not depend on what
# shares the pool or on the order of admission.

def cache_batch_axes(cfg: ModelConfig) -> Dict[str, Dict[str, int]]:
    """The batch axis of every leaf of ``init_decode_cache`` (the same
    nesting; the memory slots, None, left out), found from the shapes as
    the JAX package does: the one axis whose size follows the batch,
    between caches of B 1 and B 2 on the meta device.  Every half stacks
    its layers first, so it is axis 1 (the int8 cache's scales, MLA's
    latent and the recurrent states included), but axis 2 for xLSTM's
    mLSTM states, stacked ``[groups, blocks, B, ...]``."""
    def axis(a, b):
        if isinstance(a, dict):
            return {k: axis(a[k], b[k]) for k in a if a[k] is not None}
        diff = [i for i, (p, q) in enumerate(zip(a.shape, b.shape)) if p != q]
        if len(diff) != 1:
            raise ValueError(f"no single batch axis in cache leaf "
                             f"{tuple(a.shape)}")
        return diff[0]
    return axis(tfm.init_decode_cache(cfg, 1, 8, device="meta"),
                tfm.init_decode_cache(cfg, 2, 8, device="meta"))


SLOT_POOL_FAMILIES = ("dense", "moe", "hybrid", "ssm")


def require_one_partition(xcfg: ExchangeConfig) -> None:
    """The slot pool and the paged pool hold one partition: the JAX
    package's serving pool is not mesh-sharded either."""
    if partitioned(xcfg):
        raise NotImplementedError(
            f"the serving pools hold one partition, as the JAX package's "
            f"slot pool is not mesh-sharded; a {xcfg.mode.value} plan over "
            f"{xcfg.seq_shards} partitions has no pooled serving path")


def supports_slot_pool(cfg: ModelConfig) -> bool:
    """The tokens-only generative families share a slot pool, as in the
    JAX package: dense, gemma2's windowed local/global stack included (its
    cache's ``local`` and ``global`` halves share the slot axis), moe
    (its ``first`` and ``kv`` halves, MLA's latent cache included; a
    slot's MoE layer routes its one token alone, as the JAX package's
    per-slot ``vmap`` does), hybrid and ssm (a slot's row of the
    recurrent states, which admission copies whole with the KV rows).
    audio, vlm and vit have no poolable tokens-only cache in either
    package (a request's memory is part of its cache)."""
    return cfg.family in SLOT_POOL_FAMILIES


def sample_rows(logits: torch.Tensor, gens: List[Optional[torch.Generator]],
                temps: List[float]) -> torch.Tensor:
    """[S, V] → [S] int32: greedy rows by ``argmax``; a row with
    ``temps[i] > 0`` draws from its own generator, with the call (and so
    the draw) a B=1 ``generate`` makes for that token."""
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    for i, t in enumerate(temps):
        if t > 0.0:
            nxt[i] = sample_token(logits[i:i + 1, None], gens[i], t)[0, 0]
    return nxt


def build_prefill_fn(cfg: ModelConfig, xcfg: ExchangeConfig, *,
                     total_len: int, prefill_mode: str = "auto",
                     with_logits: bool = False) -> Callable:
    """Request admission: ``fn(params, prompt_tokens [B, T0], extras, gen,
    temp) → (tok0 [B, 1], cache, gen)`` — cache init at ``total_len`` (the
    pool's length), prompt prefill and the first token, exactly the front
    half of ``build_generate_fn`` (greedy at ``temp <= 0``, else one draw
    from ``gen``).  ``with_logits=True`` appends the last-position logits
    [B, 1, V] (the paged prefix cache keeps them, so a later full-prefix
    hit samples its own first token without a prefill)."""
    require_one_partition(xcfg)
    mode = resolve_prefill_mode(cfg, xcfg, prefill_mode)

    @torch.inference_mode()
    def pf(params, prompt_tokens, extras, gen, temp):
        B, T0 = prompt_tokens.shape
        cache = tfm.init_decode_cache(cfg, B, total_len,
                                      device=prompt_tokens.device)
        logits, cache = prefill_prompt(params, prompt_tokens, extras, cache,
                                       cfg, xcfg, mode)
        tok = sample_token(logits, gen, temp)[:, 0:1]
        if with_logits:
            return tok, cache, gen, logits
        return tok, cache, gen

    pf.prefill_mode = mode
    return pf


def build_admit_fn(cfg: ModelConfig) -> Callable:
    """Slot admission: copy a primed B=1 request cache into row ``slot`` of
    the pool and set the slot's state, in place.  The whole row goes,
    the recurrent states included, so a re-admitted slot starts from the
    new request's primed state.

    ``fn(pool, tok, lengths, gens, temps, req_cache, slot, tok0 [1,1],
    length0, gen0, temp0) → (pool, tok, lengths, gens, temps)`` (the same
    objects, updated)."""
    axes = cache_batch_axes(cfg)

    @torch.inference_mode()
    def admit(pool, tok, lengths, gens, temps, req_cache, slot, tok0,
              length0, gen0, temp0):
        def copy(pool, req, axes):
            for name, a in axes.items():
                if isinstance(a, dict):
                    copy(pool[name], req[name], a)
                else:
                    pool[name].select(a, slot).copy_(req[name].select(a, 0))
        copy(pool, req_cache, axes)
        tok[slot] = tok0[0, 0]
        lengths[slot] = length0
        gens[slot] = gen0
        temps[slot] = float(temp0)
        return pool, tok, lengths, gens, temps

    return admit


def build_decode_chunk_fn(cfg: ModelConfig, xcfg: ExchangeConfig, *,
                          n_steps: int,
                          max_len: Optional[int] = None) -> Callable:
    """A continuous-batching decode chunk over a slot pool.

    ``fn(params, pool_cache, tok [S], lengths [S], gens, temps) → (tokens
    [S, n_steps], pool_cache, lengths, gens)``: ``n_steps`` batched
    ``decode_step`` calls with a ``[S]`` ``cache_index``, each slot reading
    and writing its own cache row at its own position, then
    ``sample_rows``.  Slots that are free or finished keep decoding
    harmlessly: ``lengths`` stops at ``max_len``, and a write there lands
    on the row's last position, as the JAX package's clamped
    ``dynamic_update_slice`` does; admission re-primes the whole row."""
    require_one_partition(xcfg)

    @torch.inference_mode()
    def chunk(params, cache, tok, lengths, gens, temps):
        toks = []
        for _ in range(n_steps):
            logits, cache = tfm.decode_step(params, {"tokens": tok[:, None]},
                                            cache, lengths, cfg, xcfg)
            tok = sample_rows(logits[:, 0], gens, temps)
            lengths = lengths + 1
            if max_len is not None:
                lengths = lengths.clamp(max=max_len)
            toks.append(tok)
        return torch.stack(toks, dim=1), cache, lengths, gens

    return chunk


# ---------------------------------------------------------------------------
# paged-pool serving primitives (block KV cache + prefix caching)
# ---------------------------------------------------------------------------
#
# The paged runtime (repro_torch.serving.pages) replaces per-slot dense
# caches with ONE shared pool of fixed-size KV pages; each request owns a
# row of a [rows, max_pages] page table.  Admission primes a B=1 dense
# cache with the ordinary prefill (page-aligned length) and copies it into
# the request's pages.  Decode steps every row together against the shared
# pool with per-row positions, generators and temperatures: the per-row
# sampling of the slot pool, so paged serving stays token-exact with
# ``generate`` too.  Every function here updates the pool in place.

def build_paged_admit_fn(cfg: ModelConfig) -> Callable:
    """Paged admission: copy a primed B=1 dense request cache (page-aligned
    length P0·ps) into pool pages ``page_ids`` [P0] and set the row's
    state, in place.

    ``fn(pool, tok, lengths, gens, temps, req_cache, page_ids, row, tok0,
    length0, gen0, temp0) → (pool, tok, lengths, gens, temps)``."""

    @torch.inference_mode()
    def admit(pool, tok, lengths, gens, temps, req_cache, page_ids, row,
              tok0, length0, gen0, temp0):
        ids = page_ids.to(device=tok.device, dtype=torch.long)
        for name, p in pool["kv"].items():
            # p: [L, P, ps, Hk, dh] pool leaf; r: [L, 1, P0*ps, Hk, dh]
            r = req_cache["kv"][name]
            ps = p.shape[2]
            p[:, ids] = r.reshape(r.shape[0], r.shape[2] // ps, ps,
                                  *r.shape[3:]).to(p.dtype)
        tok[row] = tok0[0, 0]
        lengths[row] = length0
        gens[row] = gen0
        temps[row] = float(temp0)
        return pool, tok, lengths, gens, temps

    return admit


def build_paged_hit_fn(cfg: ModelConfig) -> Callable:
    """Full-prefix-hit admission: no prefill runs — the first token comes
    from the prefix entry's *cached* last-position logits with the
    request's own generator (the draw a miss makes), and the row state is
    set.

    ``fn(tok, lengths, gens, temps, row, logits [1,1,V], length0, gen0,
    temp0) → (tok, lengths, gens, temps)``."""

    @torch.inference_mode()
    def hit(tok, lengths, gens, temps, row, logits, length0, gen0, temp0):
        tok[row] = sample_token(logits, gen0, float(temp0))[0, 0]
        lengths[row] = length0
        gens[row] = gen0
        temps[row] = float(temp0)
        return tok, lengths, gens, temps

    return hit


def build_paged_suffix_fn(cfg: ModelConfig, xcfg: ExchangeConfig, *,
                          n_suffix: int) -> Callable:
    """Partial-prefix-hit admission: the shared prefix pages are already
    filled, so only the ``n_suffix`` remaining prompt tokens run —
    teacher-forced ``decode_step_paged`` steps writing straight into the
    request's pages, then the first-token draw of ``build_prefill_fn``.

    ``fn(params, pool, row_table [1, MP], suffix [1, n], start_len [1],
    gen, temp) → (tok0 [1, 1], pool, gen, logits [1, 1, V])``."""
    require_one_partition(xcfg)

    @torch.inference_mode()
    def pf(params, pool, row_table, suffix, start_len, gen, temp):
        logits = None
        for i in range(n_suffix):
            logits, pool = tfm.decode_step_paged(
                params, {"tokens": suffix[:, i:i + 1]}, pool, row_table,
                start_len + i, cfg, xcfg)
        tok = sample_token(logits, gen, temp)[:, 0:1]
        return tok, pool, gen, logits

    return pf


def build_paged_decode_chunk_fn(cfg: ModelConfig, xcfg: ExchangeConfig, *,
                                n_steps: int) -> Callable:
    """A continuous-batching decode chunk over the paged pool.

    ``fn(params, pool, page_table [S, MP], caps [S], tok [S], lengths [S],
    gens, temps) → (tokens [S, n_steps], pool, lengths, gens)``.  All rows
    advance together through ``decode_step_paged``; ``caps`` [S] is each
    row's last writable position (pages assigned · page_size − 1): rows
    whose requests are done or freed keep decoding harmlessly, their writes
    held inside their own last page (or the trash page) — active rows are
    never held back, because the runtime grows their pages over the whole
    chunk first."""
    require_one_partition(xcfg)

    @torch.inference_mode()
    def chunk(params, pool, page_table, caps, tok, lengths, gens, temps):
        toks = []
        for _ in range(n_steps):
            pos = torch.minimum(lengths, caps)
            logits, pool = tfm.decode_step_paged(
                params, {"tokens": tok[:, None]}, pool, page_table, pos,
                cfg, xcfg)
            tok = sample_rows(logits[:, 0], gens, temps)
            lengths = pos + 1
            toks.append(tok)
        return torch.stack(toks, dim=1), pool, lengths, gens

    return chunk


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
