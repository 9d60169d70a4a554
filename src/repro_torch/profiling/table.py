"""Compiled dense policy table — O(1) runtime decisions.

The seed policy rescanned (and string-decoded) the whole performance map on
every ``decide()``.  ``PolicyTable.compile`` walks the map **once** and lays
the decisions out on a dense batch-grid × bandwidth-grid: each cell holds the
candidate set and the precomputed argmin under one objective.  A runtime
query then costs two bisections plus, between profiled bandwidths, a linear
interpolation over the (constant-size) candidate set — independent of the
map size.

Batches outside the profiled grid snap to the nearest profiled batch and the
resulting :class:`Decision` is flagged ``extrapolated`` (the seed snapped
silently — B=256 quietly became B=32).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.perfmap import PerfEntry, PerfKey, PerfMap
from repro_torch.profiling.objectives import (Objective, ObjectiveLike,
                                        resolve_objective)

Candidate = Tuple[str, float, str]    # (mode, cr, codec)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """One scheduler query: how to serve ``n_queued`` requests next.

    ``batch`` is the profiled grid point to form (pad with ``padded`` empty
    slots when the queue is shorter than the cheapest grid batch);
    ``n_admit`` requests actually ride it.  ``extrapolated`` mirrors
    :class:`Decision` — the queue depth fell outside the profiled grid.
    """
    batch: int                  # profiled grid batch to form
    n_admit: int                # requests admitted (≤ batch)
    padded: int                 # empty slots in the formed batch
    decision: "Decision"        # mode/CR chosen at that grid point
    per_request_cost: float     # objective cost per admitted request
    extrapolated: bool = False


@dataclasses.dataclass(frozen=True)
class Decision:
    mode: str                  # "local" | "prism" | "voltage"
    cr: float                  # 0.0 unless prism
    expected: PerfEntry
    objective: Objective
    extrapolated: bool = False  # batch outside the profiled grid, snapped
    codec: str = ""            # exchange codec ("" = the mode's default,
                               # i.e. segment_means for prism)

    @property
    def distributed(self) -> bool:
        return self.mode != "local"

    @property
    def exec_key(self) -> str:
        """Canonical executable id this decision routes to — the ONE home
        of the ``"local"`` / ``"mode@cr[+codec]"`` convention (matches
        ``ExecutionPlan.key``)."""
        base = self.mode if self.cr <= 0 else f"{self.mode}@{self.cr:g}"
        return f"{base}+{self.codec}" if self.codec else base

    @property
    def wire_bytes(self) -> int:
        """Profiled bytes-on-wire of the expected entry (0 if the sweep
        recorded none, e.g. a local decision)."""
        return int(self.expected.meta.get("wire_bytes", 0))


def _lerp_entry(a: PerfEntry, b: PerfEntry, t: float) -> PerfEntry:
    f = lambda x, y: x + (y - x) * t
    return PerfEntry(total_ms=f(a.total_ms, b.total_ms),
                     per_sample_ms=f(a.per_sample_ms, b.per_sample_ms),
                     per_sample_j=f(a.per_sample_j, b.per_sample_j),
                     compute_ms=f(a.compute_ms, b.compute_ms),
                     staging_ms=f(a.staging_ms, b.staging_ms),
                     comm_ms=f(a.comm_ms, b.comm_ms),
                     meta={**a.meta, "interpolated_bw": True})


class PolicyTable:
    """Dense (batch × bandwidth) decision grid for one objective."""

    def __init__(self, batches: Sequence[int], bandwidths: Sequence[float],
                 cells: List[List[Dict[Candidate, PerfEntry]]],
                 objective: Objective):
        self.batches: Tuple[int, ...] = tuple(batches)
        self.bandwidths: Tuple[float, ...] = tuple(bandwidths)
        self.objective = objective
        self._cells = cells
        # precomputed per-cell argmin: (mode, cr, entry)
        self._best = [[self._argmin(cell) for cell in row] for row in cells]

    # -- construction --------------------------------------------------------

    @classmethod
    def compile(cls, pm: PerfMap, allow_modes: Sequence[str],
                objective: ObjectiveLike = "latency") -> "PolicyTable":
        obj = resolve_objective(objective)
        allow = set(allow_modes)
        local: Dict[int, PerfEntry] = {}
        dist: Dict[Tuple[int, float], Dict[Candidate, PerfEntry]] = {}
        batches, bws = set(), set()
        for k, e in pm.entries():             # the ONLY full-map walk
            if k.mode not in allow:
                continue
            batches.add(k.batch)
            if k.mode == "local":
                local[k.batch] = e
            else:
                bws.add(k.bandwidth_mbps)
                dist.setdefault((k.batch, k.bandwidth_mbps),
                                {})[(k.mode, k.cr, k.codec)] = e
        if not batches:
            raise LookupError("empty performance map")
        batch_grid = sorted(batches)
        bw_grid = sorted(bws)
        cells: List[List[Dict[Candidate, PerfEntry]]] = []
        for b in batch_grid:
            row = []
            for w in (bw_grid or [0.0]):      # local-only map: one column
                cell: Dict[Candidate, PerfEntry] = {}
                if b in local:
                    cell[("local", 0.0, "")] = local[b]
                cell.update(dist.get((b, w), {}))
                row.append(cell)
            cells.append(row)
        return cls(batch_grid, bw_grid, cells, obj)

    def _argmin(self, cell: Dict[Candidate, PerfEntry]
                ) -> Optional[Tuple[str, float, str, PerfEntry]]:
        if not cell:
            return None
        (m, cr, cod), e = min(cell.items(),
                              key=lambda kv: (self.objective.cost(kv[1]),
                                              kv[0][0] != "local", kv[0][1],
                                              kv[0][2]))
        return (m, cr, cod, e)

    # -- grid lookups ---------------------------------------------------------

    def nearest_batch(self, batch: int) -> int:
        """Snap to the nearest profiled batch (ties toward the smaller)."""
        return min(self.batches, key=lambda b: (abs(b - batch), b))

    def nearest_bandwidth(self, bandwidth_mbps: float) -> Optional[float]:
        if not self.bandwidths:
            return None
        return min(self.bandwidths, key=lambda w: abs(w - bandwidth_mbps))

    def is_extrapolated(self, batch: int) -> bool:
        return batch < self.batches[0] or batch > self.batches[-1]

    # -- the O(1) query -------------------------------------------------------

    def decide(self, batch: int, bandwidth_mbps: float) -> Decision:
        bi = bisect.bisect_left(self.batches, self.nearest_batch(batch))
        extrap = self.is_extrapolated(batch)
        bws = self.bandwidths
        if not bws or bandwidth_mbps <= bws[0]:
            return self._from_cell(bi, 0, extrap)
        if bandwidth_mbps >= bws[-1]:
            return self._from_cell(bi, len(bws) - 1, extrap)
        j = bisect.bisect_left(bws, bandwidth_mbps)
        if bws[j] == bandwidth_mbps:          # exact grid hit
            return self._from_cell(bi, j, extrap)
        return self._interp(bi, j - 1, j, bandwidth_mbps, extrap)

    def _from_cell(self, bi: int, wi: int, extrapolated: bool) -> Decision:
        best = self._best[bi][wi]
        if best is None:
            raise LookupError(
                f"no profiled candidates at batch {self.batches[bi]}")
        m, cr, cod, e = best
        return Decision(mode=m, cr=cr, expected=e, objective=self.objective,
                        extrapolated=extrapolated, codec=cod)

    def _interp(self, bi: int, w0: int, w1: int, bw: float,
                extrapolated: bool) -> Decision:
        c0, c1 = self._cells[bi][w0], self._cells[bi][w1]
        t = ((bw - self.bandwidths[w0])
             / (self.bandwidths[w1] - self.bandwidths[w0]))
        shared = [c for c in c0 if c in c1]
        if not shared:
            return self._from_cell(bi, w0 if t < 0.5 else w1, extrapolated)
        best, best_cost = None, None
        for cand in shared:
            e = _lerp_entry(c0[cand], c1[cand], t)
            cost = (self.objective.cost(e), cand[0] != "local", cand[1],
                    cand[2])
            if best_cost is None or cost < best_cost:
                best, best_cost = (cand, e), cost
        (m, cr, cod), e = best
        return Decision(mode=m, cr=cr, expected=e, objective=self.objective,
                        extrapolated=extrapolated, codec=cod)

    def candidates(self, batch: int, bandwidth_mbps: float
                   ) -> List[Tuple[PerfKey, PerfEntry]]:
        """The candidate table ``decide()`` ranks at this operating point —
        interpolated between grid bandwidths exactly like ``decide()``, so
        an explanation never shows costs its decision did not compare."""
        b = self.nearest_batch(batch)
        bi = bisect.bisect_left(self.batches, b)
        bws = self.bandwidths
        if not bws or bandwidth_mbps <= bws[0]:
            cell, label = self._cells[bi][0], (bws[0] if bws else 0.0)
        elif bandwidth_mbps >= bws[-1]:
            cell, label = self._cells[bi][-1], bws[-1]
        else:
            j = bisect.bisect_left(bws, bandwidth_mbps)
            if bws[j] == bandwidth_mbps:
                cell, label = self._cells[bi][j], bws[j]
            else:
                c0, c1 = self._cells[bi][j - 1], self._cells[bi][j]
                t = (bandwidth_mbps - bws[j - 1]) / (bws[j] - bws[j - 1])
                cell = {c: _lerp_entry(c0[c], c1[c], t)
                        for c in c0 if c in c1}
                label = bandwidth_mbps
        return [(PerfKey(m, b, cr, 0.0 if m == "local" else label, cod), e)
                for (m, cr, cod), e in cell.items()]

    # -- batch formation (serving scheduler) ----------------------------------

    def plan_batch(self, n_queued: int, bandwidth_mbps: float,
                   max_batch: Optional[int] = None) -> BatchPlan:
        """Pick the profiled batch size (and its mode/CR decision) that
        minimizes this table's objective cost **per queued request**.

        Grid batches larger than the queue are still candidates — their
        padded slots are charged to the admitted requests
        (``cost·batch/n_admit``), so a nearly-full grid batch can win while
        a mostly-empty one cannot.  ``max_batch`` caps the candidate set
        (e.g. to the runtime's free slot count); queue depths outside the
        profiled grid mark the plan ``extrapolated``.
        """
        if n_queued <= 0:
            raise ValueError("plan_batch needs n_queued >= 1")
        if max_batch is not None and max_batch <= 0:
            raise ValueError("plan_batch needs max_batch >= 1 (or None)")
        cands = [b for b in self.batches
                 if max_batch is None or b <= max_batch]
        if not cands:
            # no grid batch fits under max_batch: form the smallest grid
            # point (executables exist only at grid shapes) but admit no
            # more than the caller's cap
            cands = [self.batches[0]]
        best: Optional[BatchPlan] = None
        for b in cands:
            d = self.decide(b, bandwidth_mbps)
            n_admit = min(b, n_queued,
                          max_batch if max_batch is not None else b)
            cost = self.objective.cost(d.expected) * b / n_admit
            if best is None or cost < best.per_request_cost:
                best = BatchPlan(batch=b, n_admit=n_admit,
                                 padded=b - n_admit, decision=d,
                                 per_request_cost=cost,
                                 extrapolated=self.is_extrapolated(n_queued))
        return best

    # -- table-derived crossover artifacts ------------------------------------

    def batch_crossover(self, bandwidth_mbps: float) -> Optional[int]:
        """Smallest profiled batch at which distributed wins (paper: 8)."""
        for b in self.batches:
            if self.decide(b, bandwidth_mbps).distributed:
                return b
        return None

    def bandwidth_crossover(self, batch: int) -> Optional[float]:
        """Smallest profiled bandwidth at which distributed wins at
        ``batch`` (paper: ≈340 Mbps at B=8)."""
        for w in self.bandwidths:
            if self.decide(batch, w).distributed:
                return w
        return None

    def artifacts(self) -> Dict:
        """Every crossover the table implies — the paper-reported artifacts
        derived in one pass, serializable for reports/benchmarks."""
        return {
            "objective": self.objective.name,
            "batch_crossover_by_bw": {w: self.batch_crossover(w)
                                      for w in self.bandwidths},
            "bandwidth_crossover_by_batch": {b: self.bandwidth_crossover(b)
                                             for b in self.batches},
        }

    def __len__(self) -> int:
        return len(self.batches) * max(len(self.bandwidths), 1)
