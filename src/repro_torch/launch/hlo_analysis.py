"""The step counter: FLOPs, HBM bytes, live bytes and collective bytes of
one rank's eager step, counted as it runs on the meta device.  The port's
counterpart of ``repro.launch.hlo_analysis``, which parses XLA's compiled
HLO text; the port has no compiled artifact, so it reads what its own
eager program does instead (``StepCounter``, a ``TorchDispatchMode``).

Cost model per aten op (the JAX analyzer's rules where they have a torch
meaning):

* FLOPs: matmul-like ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  convolutions, the attention ops) by ``torch.utils.flop_counter``'s
  formulas, backward included; every other op tagged ``pointwise`` or
  ``reduction`` one FLOP per output element (pure copies, ``clone`` and
  ``copy_``, none).  A kernel that the meta route stands in for
  (``repro_torch.kernels.meta``) books its own count: operands and outputs
  once, operations over the pairs it keeps.
* HBM bytes: each op that is not a view reads its operands and writes its
  outputs, each at the bytes it spans (a view of a slice is charged as the
  slice: the JAX analyzer's slice-aware rule holds by itself in eager
  code).  An in-place op reads and writes its target.  ``empty`` and its
  kin touch nothing.
* Live bytes: every storage the step allocates on the device, tracked
  from its creation to its release (``StorageWeakRef`` and a finalizer on
  the storage: a view shares its base's storage, so storages are
  counted, not tensors).  The peak is the most that was alive at once;
  the arguments (what the step was given) are counted apart
  (``argument_bytes``).
* Collectives: each staged collective of an ``AbstractSeqGroup``
  (``repro_torch.core.seq_group``) appends a ``CollectiveRecord``: its
  primitive, the bytes this rank puts in, the ring-transfer wire bytes
  (all-gather (P − 1)·in, reduce-scatter (P − 1)/P·in, all-reduce
  2(P − 1)/P·in, collective-permute 1·in, broadcast and reduce 1·in), and
  what ``GatherStats`` books for it (kind, received bytes, calls).

Sections of the JAX report with no torch meaning: while-loop trip counts
(a Python loop runs each iteration, so each is counted as it runs),
``conditional`` branches (Python takes one), fusion parameters (eager
PyTorch fuses nothing: each op reads and writes HBM) and
``xla_cost_analysis`` (there is no XLA).

The numbers are counts of the port's program, not measurements.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten
# ops that touch no memory, or only move bytes (no FLOP)
_NO_TOUCH = {_aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided}
_COPIES = {_aten.clone, _aten.copy_, _aten.copy, _aten._to_copy}
_TAGGED = (torch.Tag.pointwise, torch.Tag.reduction)

# wire bytes a rank moves for one call, per byte it puts in (P ranks)
WIRE = {
    "all-gather": lambda P: P - 1,
    "reduce-scatter": lambda P: (P - 1) / P,
    "all-reduce": lambda P: 2 * (P - 1) / P,
    "collective-permute": lambda P: 1,
    "broadcast": lambda P: 1,
    "reduce": lambda P: 1,
}


@dataclasses.dataclass
class CollectiveRecord:
    kind: str                   # the primitive (``WIRE``'s keys)
    operand_bytes: float        # what this rank puts in
    wire_bytes: float           # ring-transfer bytes of this rank
    group_size: int
    count: float                # executions
    booked: str = ""            # the ``GatherStats`` kind it books under
    received_bytes: float = 0   # what ``GatherStats`` books as received
    calls: int = 0              # the ``GatherStats`` calls it books
    axis: str = ""              # the seq group's axis name


def collective(kind: str, operand_bytes: float, group_size: int, *,
               booked: str, received_bytes: float, calls: int,
               axis: str = "") -> CollectiveRecord:
    """One execution of ``kind`` on a group of ``group_size`` ranks."""
    return CollectiveRecord(kind, float(operand_bytes),
                            float(operand_bytes) * WIRE[kind](group_size),
                            group_size, 1.0, booked, float(received_bytes),
                            calls, axis)


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: List[CollectiveRecord] = dataclasses.field(
        default_factory=list)

    def scaled(self, k: float) -> "HloCost":
        return HloCost(self.flops * k, self.bytes * k,
                       [dataclasses.replace(
                           c, operand_bytes=c.operand_bytes * k,
                           wire_bytes=c.wire_bytes * k, count=c.count * k,
                           received_bytes=c.received_bytes * k,
                           calls=int(round(c.calls * k)))
                        for c in self.collectives])

    def add(self, other: "HloCost") -> None:
        self.flops += other.flops
        self.bytes += other.bytes
        self.collectives.extend(other.collectives)

    @property
    def collective_operand_bytes(self) -> float:
        return sum(c.operand_bytes for c in self.collectives)

    @property
    def collective_wire_bytes(self) -> float:
        return sum(c.wire_bytes for c in self.collectives)

    @property
    def collective_received_bytes(self) -> float:
        return sum(c.received_bytes for c in self.collectives)

    @property
    def collective_calls(self) -> int:
        return sum(c.calls for c in self.collectives)

    def collective_summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"operand_bytes": 0.0, "wire_bytes": 0.0, "count": 0.0,
                     "received_bytes": 0.0, "calls": 0})
        for c in self.collectives:
            out[c.kind]["operand_bytes"] += c.operand_bytes
            out[c.kind]["wire_bytes"] += c.wire_bytes
            out[c.kind]["count"] += c.count
            out[c.kind]["received_bytes"] += c.received_bytes
            out[c.kind]["calls"] += c.calls
        return dict(out)


def _tensors(tree: Any) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _flat(x, acc: list) -> list:
    """The tensors of an op's arguments or outputs, appended to ``acc``."""
    if isinstance(x, torch.Tensor):
        acc.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, acc)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, acc)
    return acc


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` addresses: its elements, or its storage's where it
    broadcasts a smaller one (an expanded view is read once)."""
    n = t.numel() * t.element_size()
    return n if t.is_contiguous() else min(n, t.untyped_storage().nbytes())


def storage_bytes(*trees: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``trees``."""
    seen = {}
    for tree in trees:
        for t in _tensors(tree):
            st = t.untyped_storage()
            seen[StorageWeakRef(st)] = st.nbytes()
    return sum(seen.values())


_FRESH: Dict[Any, bool] = {}


def _fresh(func) -> bool:
    """Does ``func`` return new tensors only (no view, nothing written in
    place, no alias of an argument)?"""
    got = _FRESH.get(func)
    if got is None:
        schema = func._schema
        got = not func.is_view and not any(
            a.alias_info is not None
            for a in list(schema.arguments) + list(schema.returns))
        _FRESH[func] = got
    return got


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _memo_key(func, tree) -> Optional[tuple]:
    """A hashable key of ``func`` and its arguments' metadata (a tensor's
    shape, strides, dtype and device; a plain value itself), or None
    where an argument is of another kind."""
    parts = [func]

    def walk(x) -> bool:
        if isinstance(x, torch.Tensor):
            parts.append((tuple(x.shape), x.stride(), x.dtype, x.device))
        elif isinstance(x, (list, tuple)):
            parts.append(len(x))
            return all(walk(v) for v in x)
        elif isinstance(x, dict):
            for k in sorted(x):
                parts.append(k)
                if not walk(x[k]):
                    return False
        elif isinstance(x, _PLAIN):
            parts.append((type(x), x))
        else:
            return False
        return True
    return tuple(parts) if walk(tree) else None


def _template(out):
    """``out`` with each tensor replaced by its metadata."""
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (list, tuple)):
        return type(out)(_template(v) for v in out)
    return out


def _rebuilt(tpl):
    if isinstance(tpl, tuple) and tpl and tpl[0] == "T":
        return torch.empty_strided(tpl[1], tpl[2], dtype=tpl[3],
                                   device=tpl[4])
    if isinstance(tpl, (list, tuple)):
        return type(tpl)(_rebuilt(v) for v in tpl)
    return tpl


_ACTIVE: List["StepCounter"] = []


def active_counter() -> Optional["StepCounter"]:
    """The innermost ``StepCounter`` running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


class StepCounter(TorchDispatchMode):
    """Counts the FLOPs, HBM bytes, live device bytes and collectives of
    the aten ops on meta tensors run inside it (see the module's note; an
    op on another device, such as a host tensor's, counts nothing)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[CollectiveRecord] = []
        self.by_op: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0,
                                                                  0.0])
        self.live = 0              # bytes the step allocated, still alive
        self.peak = 0              # the most ``live`` reached
        self._alive: Dict[StorageWeakRef, int] = {}
        self._host = 0             # inside ``host()``: nothing counts
        self._memo: Dict[Any, Any] = {}      # see ``_run``

    # --- the mode -----------------------------------------------------------

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def host(self):
        """A block whose ops count nothing: host staging buffers that the
        abstract collectives stand in for on the meta device."""
        self._host += 1
        try:
            yield
        finally:
            self._host -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        if self._host:
            return out
        ins = [t for t in _flat((args, kwargs), []) if t.is_meta]
        outs = [t for t in _flat(out, []) if t.is_meta]
        if not ins and not outs:
            return out
        packet = func.overloadpacket
        if func.is_view:
            return out                 # free, and no storage of its own
        if packet not in _NO_TOUCH:
            moved = sum(_span_bytes(t) for t in ins) + \
                sum(_span_bytes(t) for t in outs)
            flops = 0.0
            if packet in flop_registry:
                flops = float(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
            elif packet not in _COPIES and any(tag in func.tags
                                               for tag in _TAGGED):
                flops = float(sum(t.numel() for t in outs))
            self.book(str(packet), flops, moved)
        if not _fresh(func):           # in place, out=, or aliasing
            have = {StorageWeakRef(t.untyped_storage()) for t in ins}
            outs = [t for t in outs
                    if StorageWeakRef(t.untyped_storage()) not in have]
        self._track(outs)
        return out

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``.  The outputs of an op that allocates
        fresh ones are rebuilt from the metadata its first call with the
        same input metadata gave (many meta kernels are Python, and a time
        loop repeats the same few calls)."""
        key = _memo_key(func, (args, kwargs)) if _fresh(func) else None
        if key is not None:
            hit = self._memo.get(key)
            if hit is not None:
                return _rebuilt(hit)
        out = func(*args, **kwargs)
        if key is not None:
            ins = {StorageWeakRef(t.untyped_storage())
                   for t in _flat((args, kwargs), [])}
            if any(StorageWeakRef(t.untyped_storage()) in ins
                   for t in _flat(out, [])):
                _FRESH[func] = False       # aliases undeclared (_unsafe_view)
            else:
                self._memo[key] = _template(out)
        return out

    def _track(self, outs) -> None:
        """Start counting the storages of ``outs`` (the op allocated
        them)."""
        for t in outs:
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            if ref in self._alive:
                continue
            n = st.nbytes()
            self._alive[ref] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, ref)

    def _release(self, ref) -> None:
        n = self._alive.pop(ref, 0)
        self.live -= n

    # --- what the wrappers book ------------------------------------------

    def book(self, name: str, flops: float, moved: float) -> None:
        """FLOPs and HBM bytes of one op (or one kernel) called ``name``."""
        self.flops += flops
        self.bytes += moved
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += moved

    def add_collective(self, rec: CollectiveRecord, moved: float = 0.0
                       ) -> None:
        """One collective and the device bytes it reads and writes."""
        self.collectives.append(rec)
        self.bytes += moved

    def cost(self) -> HloCost:
        return HloCost(self.flops, self.bytes, list(self.collectives))

    def output_bytes(self, tree: Any) -> int:
        """Bytes of the storages in ``tree`` that the step allocated and
        that are alive (the step's outputs)."""
        seen = {}
        for t in _tensors(tree):
            ref = StorageWeakRef(t.untyped_storage())
            if ref in self._alive:
                seen[ref] = self._alive[ref]
        return sum(seen.values())


def book_kernel(name: str, flops: float, moved: float) -> None:
    """Book a kernel's own count to the counter running, if any (the meta
    route of ``repro_torch.kernels``)."""
    counter = active_counter()
    if counter is not None:
        counter.book(name, flops, moved)


def analysis_dict(cost: HloCost, n_chips: int) -> Dict:
    """Roofline terms of one rank's step on the H100 (the port's card):
    FLOPs over the bf16 dense peak, HBM bytes over the HBM rate, and the
    staged collectives by the ``H100_GLOO_STAGED`` link's own formula
    (calls · ``staging_fixed_ms`` + 2 · received bytes /
    ``staging_bw_base``: every received byte staged twice, device → host
    → device).  That preset models staging 1.6–2.8× under what the ranks
    measure (ROADMAP [5.2]), so ``collective_s`` is low by as much."""
    from repro_torch.profiling.hardware import (H100_GLOO_STAGED,
                                                H100_HBM_BW,
                                                H100_PEAK_FLOPS)
    link = H100_GLOO_STAGED
    return {
        "per_device_flops": cost.flops,
        "per_device_hbm_bytes": cost.bytes,
        "per_device_collective_operand_bytes": cost.collective_operand_bytes,
        "per_device_collective_wire_bytes": cost.collective_wire_bytes,
        "per_device_collective_received_bytes":
            cost.collective_received_bytes,
        "collective_calls": cost.collective_calls,
        "collectives": cost.collective_summary(),
        "n_chips": n_chips,
        "compute_s": cost.flops / H100_PEAK_FLOPS,
        "memory_s": cost.bytes / H100_HBM_BW,
        "collective_s": (cost.collective_calls * link.staging_fixed_ms / 1e3
                         + 2 * cost.collective_received_bytes
                         / link.staging_bw_base),
    }
