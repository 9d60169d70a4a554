"""Paged KV-cache pool: block allocator, prefix cache, paged serving pool.

Port of ``repro.serving.pages``.  The host bookkeeping (allocator, prefix
cache, admission paths) is the JAX package's; the device side differs only
in that the pool is one set of tensors updated in place — page copies,
revived pages and admissions write into it, and every decode step writes
its K/V there through the page table, read back by the paged flash-decode
kernel (``repro_torch.kernels.flash_decode.paged``) without a gather.

The dense :class:`~repro_torch.serving.engine.SlotPool` reserves
``max_len`` positions per slot up front, so a pool sized for long requests
strands most of its memory on short ones.  This module replaces that with
vLLM-style paging: one shared device pool of fixed-size KV pages
(``[n_layers, n_pages, page_size, Hk, dh]`` per leaf), per-request page
tables, and a host-side free-list allocator that grows a request's table
page-by-page as decode advances.  Admission is bounded by *free pages*, not
free rows, so concurrency at a fixed memory budget scales with actual
sequence lengths instead of the worst case.

Three mechanisms ride on the page indirection:

* **Prefix caching** — completed prefills are remembered keyed by a running
  hash of the prompt; a new request whose prompt extends a cached prefix
  skips the prefill for the shared pages entirely (full hit: first token is
  sampled from the entry's cached last-position logits; partial hit: only
  the suffix is teacher-forced through the pool).  Sharing is
  copy-on-write at page granularity: an unaligned tail page is copied
  before the new request may write into it, so sharers never collide.
* **Commitment admission** — ``can_admit`` reserves the request's whole
  page need (``ceil(total_len / page_size)``) against the free list at
  admission; on-demand growth then draws on that reservation, so decode
  can never deadlock mid-request on an empty free list.
* **Cold-page quantization** (optional, **lossy**) — prefix entries idle
  for ``cold_horizon`` admissions have their pages encoded through the
  wire codecs (``repro_torch.transport.codecs`` int8/int4), freeing the
  pages;
  a later hit decodes them back into fresh pages.  Off by default
  (``cold_horizon=None``) because dequantized history is no longer
  bit-exact with a fresh prefill.

The **trash page** convention: the device pool is created with one extra
page (id ``n_pages``) that the allocator never hands out.  Idle rows keep
their page-table row pointed at it, so the fixed-shape decode chunk can
advance every row unconditionally — writes from vacant or finished rows
land in the trash page (or clamp inside the row's own last page via
``caps``) and are never validly read.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import maybe_span
from repro_torch.serving.queue import Request


class PagesExhausted(RuntimeError):
    """Admission was attempted without enough uncommitted free pages."""


# ---------------------------------------------------------------------------
# Page allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list page allocator with refcounts and admission commitments.

    Pages are shared (prefix cache + any number of requests), so each holder
    retains a reference; a page returns to the free list only when the last
    holder releases it.  ``commit`` reserves pages for an admitted request
    before they are physically allocated — ``available()`` is what a *new*
    admission may claim, keeping on-demand growth deadlock-free.
    """

    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ValueError("n_pages must be >= 1")
        self.n_pages = n_pages
        # LIFO: low page ids hand out first (stable tests, warm reuse)
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.refs: Dict[int, int] = {}
        self.committed = 0

    def available(self) -> int:
        """Free pages not already promised to an admitted request."""
        return len(self.free) - self.committed

    # -- commitments ---------------------------------------------------------

    def commit(self, n: int) -> None:
        if n > self.available():
            raise PagesExhausted(
                f"commit({n}) exceeds available ({self.available()})")
        self.committed += n

    def uncommit(self, n: int) -> None:
        if n > self.committed:
            raise RuntimeError(f"uncommit({n}) exceeds committed "
                               f"({self.committed})")
        self.committed -= n

    # -- pages ---------------------------------------------------------------

    def alloc(self, n: int, committed: bool = True) -> List[int]:
        """Pop ``n`` pages (each at refcount 1).  ``committed=True`` draws
        on a prior :meth:`commit` reservation; ``committed=False`` (cache
        revival) must fit in what admissions have not reserved."""
        if committed:
            if n > self.committed:
                raise RuntimeError(
                    f"alloc({n}) draws past the commitment ({self.committed})")
            self.committed -= n
        elif n > self.available():
            raise PagesExhausted(
                f"alloc({n}, committed=False) exceeds available "
                f"({self.available()})")
        ids = [self.free.pop() for _ in range(n)]
        for pid in ids:
            self.refs[pid] = 1
        return ids

    def retain(self, pid: int) -> None:
        self.refs[pid] += 1

    def release(self, pid: int) -> int:
        """Drop one reference; returns 1 if the page went back to the free
        list, 0 if other holders remain.  Double-free raises."""
        if pid not in self.refs:
            raise KeyError(f"release of unallocated page {pid}")
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            del self.refs[pid]
            self.free.append(pid)
            return 1
        return 0

    def check(self) -> None:
        """Invariants (property tests): full partition, no overlap, and
        commitments covered by the free list."""
        if len(self.free) + len(self.refs) != self.n_pages:
            raise AssertionError("page leak: free + live != total")
        if set(self.free) & set(self.refs):
            raise AssertionError("page on free list while referenced")
        if not 0 <= self.committed <= len(self.free):
            raise AssertionError("commitments exceed the free list")


# ---------------------------------------------------------------------------
# Prefix cache
# ---------------------------------------------------------------------------

def _prefix_digests(prompt: np.ndarray) -> List[bytes]:
    """Running blake2b over the prompt: ``out[i]`` keys tokens ``[: i+1]``.
    One pass (``hashlib`` digests do not finalize), so probing every prefix
    length is O(T0) total."""
    h = hashlib.blake2b(digest_size=16)
    out: List[bytes] = []
    for t in prompt:
        h.update(int(t).to_bytes(4, "little", signed=True))
        out.append(h.digest())
    return out


@dataclasses.dataclass
class PrefixEntry:
    """One cached prompt prefill: its prompt pages + last-position logits.

    ``tail`` (when the prompt is not page-aligned) holds only
    ``tail_valid`` valid positions — readers must COW-copy it before
    writing at their own frontier.  Cold entries hold codec payloads
    instead of pages (``full_pages`` empty, ``tail`` None)."""
    digest: bytes
    n_tok: int
    full_pages: List[int]
    tail: Optional[int]
    tail_valid: int
    logits: Any                        # [1, 1, V] device, prefill last pos
    last_used: int = 0
    hits: int = 0
    cold: bool = False
    payloads: Optional[Dict[str, Dict[str, Any]]] = None  # per pool leaf
    n_full: int = 0                    # layout memo for cold revival
    had_tail: bool = False

    def pages(self) -> List[int]:
        return self.full_pages + ([self.tail] if self.tail is not None
                                  else [])


class PrefixCache:
    """Host-side index of :class:`PrefixEntry` keyed by prompt digest.

    ``lookup`` probes every prefix length of the incoming prompt, longest
    first.  Entries are evicted LRU (``last_used`` is an admission counter,
    not wall time) when admissions need their pages or the entry bound is
    hit; evicting only releases the *cache's* references, so pages shared
    with in-flight requests stay alive until those requests finish.
    """

    def __init__(self, alloc: PageAllocator, max_entries: int = 128):
        self.alloc = alloc
        self.max_entries = max_entries
        self.entries: Dict[bytes, PrefixEntry] = {}
        self.clock = 0                 # admission counter (LRU + cold age)
        self.evictions = 0

    def lookup(self, prompt: np.ndarray) -> Optional[PrefixEntry]:
        ds = _prefix_digests(prompt)
        for i in range(len(ds) - 1, -1, -1):
            e = self.entries.get(ds[i])
            if e is not None:
                return e
        return None

    def insert(self, prompt: np.ndarray, pages: List[int], logits,
               page_size: int) -> Optional[PrefixEntry]:
        """Remember a freshly prefilled prompt.  ``pages`` is the owning
        row's page list; the cache retains its own reference on each prompt
        page so they outlive the request."""
        digest = _prefix_digests(prompt)[-1]
        existing = self.entries.get(digest)
        if existing is not None:
            existing.last_used = self.clock
            return existing
        n_tok = int(len(prompt))
        n_full = n_tok // page_size
        tail = pages[n_full] if n_tok % page_size else None
        full = list(pages[:n_full])
        for pid in full + ([tail] if tail is not None else []):
            self.alloc.retain(pid)
        e = PrefixEntry(digest=digest, n_tok=n_tok, full_pages=full,
                        tail=tail, tail_valid=n_tok % page_size,
                        logits=logits, last_used=self.clock)
        while len(self.entries) >= self.max_entries:
            lru = min(self.entries, key=lambda d: self.entries[d].last_used)
            self.evict_entry(lru)
        self.entries[digest] = e
        return e

    def evict_entry(self, digest: bytes) -> int:
        """Drop one entry; returns how many pages went back to the free
        list (0 for cold entries or pages still shared with requests)."""
        e = self.entries.pop(digest)
        freed = 0
        if not e.cold:
            for pid in e.pages():
                freed += self.alloc.release(pid)
        self.evictions += 1
        return freed

    def make_room(self, n_short: int) -> int:
        """Evict LRU entries until ~``n_short`` pages came free (or no hot
        entry remains)."""
        gained = 0
        while gained < n_short:
            hot = [d for d, e in self.entries.items() if not e.cold]
            if not hot:
                break
            lru = min(hot, key=lambda d: self.entries[d].last_used)
            gained += self.evict_entry(lru)
        return gained

    def reclaimable(self) -> int:
        """Pages that evicting every idle entry would free right now
        (refcount 1 = held only by the cache)."""
        return sum(1 for e in self.entries.values() if not e.cold
                   for pid in e.pages() if self.alloc.refs.get(pid) == 1)


# ---------------------------------------------------------------------------
# Device helpers (in place: the pool is never copied)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def _copy_page(pool, src: int, dst: int):
    """Copy-on-write split: duplicate physical page ``src`` into ``dst``
    across every pool leaf, in place (the JAX package donates the pool to
    a jitted copy)."""
    for leaf in pool["kv"].values():
        leaf[:, dst] = leaf[:, src]
    return pool


@torch.inference_mode()
def _write_pages(pool, idx: torch.Tensor, values: Dict[str, torch.Tensor]):
    """Scatter revived page contents into the pool, in place."""
    for name, leaf in pool["kv"].items():
        leaf[:, idx] = values[name].to(leaf.dtype)
    return pool


@torch.inference_mode()
def _set_row(tok, lengths, gens, temps, slot, tok0, length, gen, temp):
    """Write one slot's decode-state row."""
    tok[slot] = tok0
    lengths[slot] = length
    gens[slot] = gen
    temps[slot] = float(temp)
    return tok, lengths, gens, temps


# ---------------------------------------------------------------------------
# Paged pool
# ---------------------------------------------------------------------------

class PagedPool:
    """Paged drop-in for :class:`~repro_torch.serving.engine.SlotPool`.

    Same host interface (``admit`` / ``evict`` / ``drain`` /
    ``decode_chunk`` / ``free_slots`` / ``n_active``) so
    :class:`~repro_torch.serving.engine.ServingRuntime` drives either, plus
    ``can_admit`` (page-commitment check) and ``page_stats``.  Decode
    steps every row together against the shared pool; the page table and
    caps go to the device once per chunk.
    """

    def __init__(self, session, plan, n_rows: int, *, n_pages: int,
                 page_size: int, max_pages: int, prefix_cache: bool = True,
                 cold_horizon: Optional[int] = None,
                 cold_codec: str = "int8", max_entries: int = 128):
        if n_pages < max_pages:
            raise ValueError(
                f"n_pages ({n_pages}) < max_pages ({max_pages}): a "
                "max-length request could never be admitted")
        self.session = session
        self.plan = plan
        self.n_rows = n_rows
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self.cold_horizon = cold_horizon
        self.cold_codec = cold_codec
        # +1 page: the trash page (id == n_pages) absorbing idle-row writes
        self.pool = session.init_page_pool(n_pages + 1, page_size)
        self.trash = n_pages
        self.alloc = PageAllocator(n_pages)
        self.prefix = (PrefixCache(self.alloc, max_entries=max_entries)
                       if prefix_cache else None)
        self.page_table = np.full((n_rows, max_pages), self.trash, np.int32)
        self.row_pages: List[List[int]] = [[] for _ in range(n_rows)]
        self.row_committed = [0] * n_rows
        self.row_len = [0] * n_rows
        self.tok = torch.zeros((n_rows,), dtype=torch.int32,
                               device=session.device)
        self.lengths = torch.zeros((n_rows,), dtype=torch.int32,
                                   device=session.device)
        self.gens: List[Optional[torch.Generator]] = [None] * n_rows
        self.temps: List[float] = [0.0] * n_rows
        self.slots: List[Optional[Any]] = [None] * n_rows
        self.tracer = None                 # set by ServingRuntime._pool
        self.trace_worker = ""
        self.stats = {"prefix_hits": 0, "prefix_misses": 0, "full_hits": 0,
                      "partial_hits": 0, "cow_splits": 0, "cold_pages": 0,
                      "dequant_pages": 0}
        # pages the in-flight admit alloc'd/retained (rollback journal)
        self._acquired: List[int] = []

    # -- occupancy -----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _need(self, req: Request) -> int:
        return -(-req.total_len // self.page_size)

    def can_admit(self, req: Request) -> bool:
        """Whole-request page commitment against the free list (counting
        pages LRU prefix eviction could reclaim).  Conservative: prefix
        sharing would lower the true need, but a hit is only known at
        admission."""
        avail = self.alloc.available()
        if self.prefix is not None:
            avail += self.prefix.reclaimable()
        return self._need(req) <= avail

    # -- admission -----------------------------------------------------------

    def _reserve(self, n: int) -> bool:
        if self.alloc.available() < n and self.prefix is not None:
            self.prefix.make_room(n - self.alloc.available())
        if self.alloc.available() < n:
            return False
        self.alloc.commit(n)
        return True

    def admit(self, req: Request, slot: int, exec_key: str,
              extrapolated: bool, now: float):
        """Admit one request into ``slot``: prefix-cache probe, then the
        full-hit / partial-hit / miss path.  Commits the request's whole
        page need first, so later on-demand growth cannot starve."""
        from repro_torch.serving.engine import _Active
        from repro_torch.transport import plan_wire_bytes
        if self.slots[slot] is not None:
            raise RuntimeError(f"row {slot} is occupied")
        ps = self.page_size
        if req.total_len > self.max_pages * ps:
            raise ValueError(
                f"request needs {req.total_len} positions but the page "
                f"table is sized for {self.max_pages * ps}; raise "
                "ServingRuntime(max_len=)")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        T0 = int(prompt.shape[0])
        P0 = -(-T0 // ps)
        total = self._need(req)

        entry = None
        reserved = 0
        if self.prefix is not None:
            self.prefix.clock += 1
            entry = self.prefix.lookup(prompt)
            if entry is not None and entry.cold:
                entry = self._revive(entry)
            if entry is not None:
                # Shield the entry from the LRU sweep _reserve may run:
                # its last_used is otherwise bumped only by the hit
                # handlers, so make_room could evict it out from under us
                # and free the very pages the hit is about to retain.
                entry.last_used = self.prefix.clock
                reserved = total - len(entry.full_pages)
                if not self._reserve(reserved):
                    entry, reserved = None, 0  # pressure: fall back to miss
                elif self.prefix.entries.get(entry.digest) is not entry:
                    # make_room evicted it anyway (it was the only hot
                    # entry); its cache-only pages are free again and the
                    # hit is void — return the reservation, run as a miss
                    self.alloc.uncommit(reserved)
                    entry, reserved = None, 0

        if entry is None:
            reserved = total
            if not self._reserve(total):
                raise PagesExhausted(
                    f"admission needs {total} pages; "
                    f"{self.alloc.available()} available")

        committed0 = self.alloc.committed
        self._acquired = []
        try:
            if entry is None:
                pages, first_tok, prompt_wire = self._admit_miss(
                    prompt, P0, slot, req)
            elif entry.n_tok == T0:
                pages, first_tok = self._admit_full_hit(entry, slot, req, T0)
                prompt_wire = 0        # no prefill ran, nothing crossed wire
            else:
                pages, first_tok = self._admit_partial_hit(
                    entry, prompt, P0, slot, req)
                prompt_wire = T0 - entry.n_tok

            self.page_table[slot, :len(pages)] = pages
            self.row_pages[slot] = pages
            self.row_committed[slot] = total - P0
            self.row_len[slot] = T0
            wire = plan_wire_bytes(self.plan, self.session.cfg, 1,
                                   prompt_wire) if prompt_wire else 0
            act = _Active(request=req, admitted_ts=now, exec_key=exec_key,
                          extrapolated=extrapolated, first_tok=first_tok,
                          codec=(self.plan.effective_codec if wire else ""),
                          wire_bytes=wire)
            self.slots[slot] = act
        except BaseException:
            self._rollback_admit(slot, reserved, committed0)
            raise
        finally:
            self._acquired = []
        if self.prefix is not None and self.cold_horizon is not None:
            self._sweep_cold()
        return act

    def _rollback_admit(self, slot: int, reserved: int,
                        committed0: int) -> None:
        """Undo a failed admission: release every page it alloc'd or
        retained, return the unspent part of its reservation, and clear
        the row, so one bad admit cannot shrink the pool for everyone
        after it.  References the prefix cache took for itself (via
        ``insert``) are the cache's own and stay."""
        drawn = committed0 - self.alloc.committed
        for pid in self._acquired:
            self.alloc.release(pid)
        self.alloc.uncommit(reserved - drawn)
        self.slots[slot] = None
        self.row_pages[slot] = []
        self.row_committed[slot] = 0
        self.row_len[slot] = 0
        self.page_table[slot, :] = self.trash

    def _admit_miss(self, prompt, P0: int, slot: int, req: Request):
        """Prefill at page-aligned length, scatter into fresh pages, and
        remember the prompt in the prefix cache."""
        ps = self.page_size
        ids = self.alloc.alloc(P0)
        self._acquired.extend(ids)
        with maybe_span(self.tracer, "prefill", kind="serving",
                        worker=self.trace_worker,
                        prompt_len=int(prompt.shape[0]), hit="miss"):
            tok0, cache, gen, logits = self.session.prime_slot(
                prompt[None], total_len=P0 * ps,
                plan=self.plan, seed=req.seed,
                temperature=req.temperature, with_logits=True)
        with maybe_span(self.tracer, "admit", kind="serving",
                        worker=self.trace_worker, slot=slot, pages=P0):
            (self.pool, self.tok, self.lengths, self.gens, self.temps) = \
                self.session.admit_paged(self.pool, self.tok, self.lengths,
                                         self.gens, self.temps, cache,
                                         torch.as_tensor(ids), slot,
                                         tok0, len(prompt), gen,
                                         req.temperature)
        if self.prefix is not None:
            self.stats["prefix_misses"] += 1
            self.prefix.insert(prompt, ids, logits, ps)
        return list(ids), tok0, len(prompt)

    def _cow_tail(self, entry: PrefixEntry) -> int:
        """COW split of an unaligned shared tail page: the admitting
        request writes at its frontier inside this page, so it gets a
        private copy (sharers keep reading the original)."""
        dst = self.alloc.alloc(1)[0]
        self._acquired.append(dst)
        with maybe_span(self.tracer, "cow_split", kind="serving",
                        worker=self.trace_worker, src=int(entry.tail),
                        dst=int(dst)):
            self.pool = _copy_page(self.pool, entry.tail, dst)
        self.stats["cow_splits"] += 1
        return dst

    def _admit_full_hit(self, entry: PrefixEntry, slot: int, req: Request,
                        T0: int):
        """Exact-prompt hit: zero prefill.  First token is sampled from the
        entry's cached logits with this request's own fresh generator — the
        draw a miss makes, so the token chain is identical."""
        pages = []
        for pid in entry.full_pages:
            self.alloc.retain(pid)
            self._acquired.append(pid)
            pages.append(pid)
        if entry.tail is not None:
            pages.append(self._cow_tail(entry))
        with maybe_span(self.tracer, "admit", kind="serving",
                        worker=self.trace_worker, slot=slot, hit="full"):
            (self.tok, self.lengths, self.gens, self.temps) = \
                self.session.hit_paged(self.tok, self.lengths, self.gens,
                                       self.temps, slot, entry.logits, T0,
                                       self.session.generator(req.seed),
                                       req.temperature)
        entry.hits += 1
        entry.last_used = self.prefix.clock
        self.stats["prefix_hits"] += 1
        self.stats["full_hits"] += 1
        return pages, self.tok[slot].clone()[None, None]

    def _admit_partial_hit(self, entry: PrefixEntry, prompt, P0: int,
                           slot: int, req: Request):
        """Prompt extends a cached prefix: retain the shared full pages,
        COW-copy the unaligned tail, then teacher-force only the suffix
        through the pool (the decode-loop prefill ≡ single-pass for these
        families)."""
        n = entry.n_tok
        pages = []
        for pid in entry.full_pages:
            self.alloc.retain(pid)
            self._acquired.append(pid)
            pages.append(pid)
        if entry.tail is not None:
            pages.append(self._cow_tail(entry))
        grown = self.alloc.alloc(P0 - len(pages))
        self._acquired.extend(grown)
        pages.extend(grown)
        self.page_table[slot, :P0] = pages
        with maybe_span(self.tracer, "prefill", kind="serving",
                        worker=self.trace_worker, hit="partial",
                        cached=int(n),
                        prompt_len=int(prompt.shape[0])):
            tok0, self.pool, gen, logits = self.session.suffix_paged(
                self.pool, self.page_table[slot:slot + 1],
                prompt[None, n:], np.asarray([n], np.int32),
                self.session.generator(req.seed), req.temperature,
                plan=self.plan)
        (self.tok, self.lengths, self.gens, self.temps) = _set_row(
            self.tok, self.lengths, self.gens, self.temps, slot, tok0[0, 0],
            len(prompt), gen, float(req.temperature))
        entry.hits += 1
        entry.last_used = self.prefix.clock
        self.stats["prefix_hits"] += 1
        self.stats["partial_hits"] += 1
        if self.prefix is not None:
            self.prefix.insert(prompt, pages, logits, self.page_size)
        return pages, tok0

    # -- eviction ------------------------------------------------------------

    def evict(self, slot: int):
        act, self.slots[slot] = self.slots[slot], None
        for pid in self.row_pages[slot]:
            self.alloc.release(pid)
        self.alloc.uncommit(self.row_committed[slot])
        self.row_pages[slot] = []
        self.row_committed[slot] = 0
        self.row_len[slot] = 0
        self.page_table[slot, :] = self.trash
        return act

    def drain(self) -> List[Request]:
        """Drop every in-flight request (fault re-admission path)."""
        reqs = []
        for i, act in enumerate(self.slots):
            if act is not None:
                reqs.append(self.evict(i).request)
        return reqs

    # -- decode --------------------------------------------------------------

    def _ensure(self, row: int, n_steps: int) -> None:
        """Grow the row's page table to cover the whole next chunk, drawing
        on the commitment made at admission (never past the request's total
        need — once the request is done, extra steps clamp at ``caps``)."""
        ps = self.page_size
        act = self.slots[row]
        total = self._need(act.request)
        need = min(-(-(self.row_len[row] + n_steps) // ps), total)
        extra = need - len(self.row_pages[row])
        if extra > 0:
            ids = self.alloc.alloc(extra)
            start = len(self.row_pages[row])
            self.page_table[row, start:start + extra] = ids
            self.row_pages[row].extend(ids)
            self.row_committed[row] -= extra

    def decode_chunk(self, n_steps: int) -> float:
        """One chunk over all rows; appends tokens to active requests and
        returns the wall ms the chunk took (straggler signal)."""
        t0 = time.perf_counter()
        for row, act in enumerate(self.slots):
            if act is not None:
                self._ensure(row, n_steps)
        ps = self.page_size
        caps = np.asarray([max(len(p), 1) * ps - 1 for p in self.row_pages],
                          np.int32)
        toks, self.pool, self.lengths, self.gens = \
            self.session.paged_decode_chunk(
                self.pool, self.page_table, caps,
                self.tok, self.lengths, self.gens, self.temps,
                n_steps=n_steps, plan=self.plan)
        self.tok = toks[:, -1]
        out = toks.cpu().numpy()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            self.row_len[i] += n_steps
            if act.done:
                continue
            need = act.request.n_new - act.emitted
            act.tokens.extend(int(t) for t in out[i, :need])
        return wall_ms

    # -- cold pages (lossy; off unless cold_horizon is set) ------------------

    def _codec(self):
        from repro_torch.transport.codecs import CodecSpec, get_codec
        return get_codec(self.cold_codec), CodecSpec(param=0)

    def _sweep_cold(self) -> None:
        """Quantize pages of prefix entries idle past ``cold_horizon``
        admissions and return them to the free list.  The entry's valid
        region is stable (rows never write below their own frontier), so
        the snapshot is consistent even while sharers decode."""
        for e in list(self.prefix.entries.values()):
            if e.cold or self.prefix.clock - e.last_used < self.cold_horizon:
                continue
            codec, spec = self._codec()
            idx = torch.as_tensor(e.pages(), device=self.session.device)
            with maybe_span(self.tracer, "codec_encode", kind="serving",
                            worker=self.trace_worker,
                            codec=self.cold_codec,
                            pages=int(idx.shape[0]), cold=True):
                e.payloads = {name: codec.encode(leaf[:, idx].float(), spec)
                              for name, leaf in self.pool["kv"].items()}
            e.n_full = len(e.full_pages)
            e.had_tail = e.tail is not None
            for pid in e.pages():
                self.alloc.release(pid)
            e.full_pages, e.tail, e.cold = [], None, True
            self.stats["cold_pages"] += int(idx.shape[0])

    def _revive(self, e: PrefixEntry) -> Optional[PrefixEntry]:
        """Dequantize a cold entry back into fresh (uncommitted) pages;
        under pressure the entry is dropped instead and the admission runs
        as a miss."""
        n = e.n_full + (1 if e.had_tail else 0)
        if self.alloc.available() < n:
            self.prefix.make_room(n - self.alloc.available())
        if self.alloc.available() < n:
            self.prefix.evict_entry(e.digest)
            return None
        codec, spec = self._codec()
        ids = self.alloc.alloc(n, committed=False)
        idx = torch.as_tensor(ids, device=self.session.device)
        with maybe_span(self.tracer, "codec_decode", kind="serving",
                        worker=self.trace_worker, codec=self.cold_codec,
                        pages=int(n), cold=True):
            values = {name: codec.decode(e.payloads[name], spec,
                                         dtype=leaf.dtype)
                      for name, leaf in self.pool["kv"].items()}
            self.pool = _write_pages(self.pool, idx, values)
        e.full_pages = list(ids[:e.n_full])
        e.tail = ids[e.n_full] if e.had_tail else None
        e.cold, e.payloads = False, None
        self.stats["dequant_pages"] += n
        return e

    # -- telemetry -----------------------------------------------------------

    def page_stats(self) -> Dict[str, Any]:
        free = len(self.alloc.free)
        out = {"pages_total": self.n_pages, "pages_free": free,
               "pages_committed": self.alloc.committed,
               "page_occupancy": 1.0 - free / self.n_pages}
        out.update(self.stats)
        if self.prefix is not None:
            out["prefix_entries"] = len(self.prefix.entries)
            out["prefix_evictions"] = self.prefix.evictions
            looked = self.stats["prefix_hits"] + self.stats["prefix_misses"]
            out["prefix_hit_rate"] = (self.stats["prefix_hits"] / looked
                                      if looked else 0.0)
        return out
