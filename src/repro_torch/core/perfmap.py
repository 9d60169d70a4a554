"""Performance map — the paper's profiling artifact (§3.3).

A lightweight JSON store keyed by (mode, batch, CR, bandwidth) holding the
profiled totals and the three-way latency decomposition (computation,
communication, CPU–GPU staging — on TPU: compute / wire / staging-or-DCN).
Decoded ``PerfKey`` objects are cached alongside the string store, so
iterating ``entries()``/``candidates()`` never re-parses key strings.

Schema v2 embeds the hardware the map was profiled on (a
``HardwareProfile``/``LinkProfile`` block, see ``repro_torch.profiling.hardware``)
so a map is self-describing; v1 and the pre-versioning flat format still
load (with ``hardware``/``link`` left ``None``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple


SCHEMA_VERSION = 2
_READABLE_VERSIONS = (1, SCHEMA_VERSION)


@dataclasses.dataclass(frozen=True)
class PerfKey:
    mode: str            # "local" | "voltage" | "prism"
    batch: int
    cr: float            # 0.0 for local / voltage
    bandwidth_mbps: float
    codec: str = ""      # exchange codec; "" = the mode's default
                         # (segment_means for prism — pre-codec maps load
                         # unchanged)

    def __post_init__(self):
        for field, val in (("mode", self.mode), ("codec", self.codec)):
            if "|" in val:
                raise ValueError(f"{field} {val!r} must not contain '|' "
                                 "(it is the key-encoding separator)")

    def encode(self) -> str:
        base = f"{self.mode}|{self.batch}|{self.cr:g}|{self.bandwidth_mbps:g}"
        return f"{base}|{self.codec}" if self.codec else base

    @staticmethod
    def decode(s: str) -> "PerfKey":
        parts = s.split("|")
        if len(parts) not in (4, 5):
            raise ValueError(f"malformed PerfKey string {s!r}: expected "
                             "'mode|batch|cr|bandwidth[|codec]'")
        m, b, c, w = (p.strip() for p in parts[:4])
        codec = parts[4].strip() if len(parts) == 5 else ""
        batch = float(b)           # tolerate "8.0"-style batch strings
        if batch != int(batch):
            raise ValueError(f"non-integer batch {b!r} in PerfKey {s!r}")
        return PerfKey(m, int(batch), float(c), float(w), codec)


@dataclasses.dataclass
class PerfEntry:
    total_ms: float
    per_sample_ms: float
    per_sample_j: float
    compute_ms: float
    staging_ms: float        # "Other" column of paper Table 2
    comm_ms: float           # wire time
    meta: Dict = dataclasses.field(default_factory=dict)

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d) -> "PerfEntry":
        return PerfEntry(**d)


class PerfMap:
    """The on-terminal-device JSON performance map."""

    def __init__(self):
        self._d: Dict[str, PerfEntry] = {}
        self._keys: Dict[str, PerfKey] = {}    # decoded-key cache
        self.hardware = None   # Optional[repro_torch.profiling.HardwareProfile]
        self.link = None       # Optional[repro_torch.profiling.LinkProfile]

    def put(self, key: PerfKey, entry: PerfEntry) -> None:
        enc = key.encode()
        self._d[enc] = entry
        self._keys[enc] = key

    def get(self, key: PerfKey) -> Optional[PerfEntry]:
        return self._d.get(key.encode())

    def entries(self) -> Iterable[Tuple[PerfKey, PerfEntry]]:
        for k, v in self._d.items():
            pk = self._keys.get(k)
            if pk is None:                     # key written via raw access
                pk = self._keys[k] = PerfKey.decode(k)
            yield pk, v

    # --- runtime queries -----------------------------------------------

    def candidates(self, batch: int, bandwidth_mbps: float
                   ) -> List[Tuple[PerfKey, PerfEntry]]:
        """All profiled modes at this batch, nearest profiled bandwidth."""
        bws = sorted({k.bandwidth_mbps for k, _ in self.entries()
                      if k.batch == batch})
        if not bws:
            return []
        bw = min(bws, key=lambda b: abs(b - bandwidth_mbps))
        return [(k, v) for k, v in self.entries()
                if k.batch == batch and
                (k.bandwidth_mbps == bw or k.mode == "local")]

    def batches(self) -> List[int]:
        return sorted({k.batch for k, _ in self.entries()})

    # --- persistence ------------------------------------------------------

    def to_doc(self) -> Dict:
        """The JSON-able document form — shared by ``save`` and the RPC
        ``Profile`` reply (``repro_torch.rpc``), so a map measured in a worker
        process round-trips byte-identically to one read from disk."""
        doc = {"schema_version": SCHEMA_VERSION,
               "entries": {k: e.to_dict() for k, e in self._d.items()}}
        hw = {}
        if self.hardware is not None:
            hw["device"] = self.hardware.to_dict()
        if self.link is not None:
            hw["link"] = self.link.to_dict()
        if hw:
            doc["hardware"] = hw
        return doc

    @staticmethod
    def from_doc(data: Dict, *, source: str = "<doc>") -> "PerfMap":
        pm = PerfMap()
        if "schema_version" in data:
            ver = data["schema_version"]
            if ver not in _READABLE_VERSIONS:
                raise ValueError(
                    f"{source}: performance-map schema version {ver!r} is "
                    f"not supported (this build reads versions "
                    f"{list(_READABLE_VERSIONS)}); re-run the profiling "
                    "sweep to regenerate it")
            entries = data["entries"]
            if data.get("hardware") is not None:
                pm._load_hardware(data["hardware"], source)
        else:                      # pre-versioning flat map (v0 seed format)
            entries = data
        for k, d in entries.items():
            key = PerfKey.decode(k)    # validate + cache in one pass
            pm._d[k] = PerfEntry.from_dict(d)
            pm._keys[k] = key
        return pm

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=1)
        os.replace(tmp, path)      # atomic

    @staticmethod
    def load(path: str) -> "PerfMap":
        with open(path) as f:
            data = json.load(f)
        return PerfMap.from_doc(data, source=path)

    def _load_hardware(self, block, path: str) -> None:
        from repro_torch.profiling.hardware import HardwareProfile, LinkProfile
        try:
            if not isinstance(block, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(block).__name__}")
            if "device" in block:
                self.hardware = HardwareProfile.from_dict(block["device"])
            if "link" in block:
                self.link = LinkProfile.from_dict(block["link"])
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"{path}: corrupt hardware block in performance map: {e}"
            ) from e

    def __len__(self) -> int:
        return len(self._d)
