"""`repro_torch.serving` — the policy-driven serving runtime of the port.

Request traffic goes queue → scheduler → runtime:

* :class:`Request` / :class:`RequestQueue` — bounded intake with arrival
  timestamps and per-request SLO deadlines.
* :class:`AdaptiveScheduler` — micro-batch formation from the compiled
  policy table (batch size AND mode/CR/codec chosen per the active
  objective).
* :class:`ServingRuntime` — continuous-batching decode on a slot-based
  KV-cache pool (admit between chunks, evict finished), with
  fault/straggler hooks; the slot pool decodes on the flash-decode kernel.
* :class:`PagedPool` / :class:`PageAllocator` / :class:`PrefixCache` —
  paged mode (``ServingRuntime(page_size=..., n_pages=...)``): a shared
  pool of fixed-size KV pages with commitment-based admission,
  copy-on-write prefix sharing and optional cold-page quantization,
  decoded on the paged flash-decode kernel.

Port of ``repro.serving``; its dry-run step builders are not ported.
"""
from repro_torch.serving.engine import Completion, ServingRuntime, SlotPool
from repro_torch.serving.pages import (PageAllocator, PagedPool,
                                       PagesExhausted, PrefixCache,
                                       PrefixEntry)
from repro_torch.serving.queue import QueueFull, Request, RequestQueue
from repro_torch.serving.scheduler import (AdaptiveScheduler, FailoverEvent,
                                           FaultHook, MicroBatch,
                                           RebalanceEvent, StragglerHook)

__all__ = ["Request", "RequestQueue", "QueueFull",
           "AdaptiveScheduler", "MicroBatch",
           "ServingRuntime", "SlotPool", "Completion",
           "PagedPool", "PageAllocator", "PrefixCache", "PrefixEntry",
           "PagesExhausted",
           "FaultHook", "StragglerHook", "FailoverEvent", "RebalanceEvent"]
