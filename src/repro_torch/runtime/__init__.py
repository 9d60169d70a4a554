"""`repro_torch.runtime` — liveness, straggler and restart machinery: the
serving runtime's hooks (``HeartbeatMonitor``, ``StragglerMitigator``) and
the trainer's checkpoint-restart loop (``FaultTolerantLoop``)."""
from repro_torch.runtime.fault import (FaultEvent, FaultTolerantLoop,
                                       HeartbeatMonitor)
from repro_torch.runtime.straggler import StragglerMitigator

__all__ = ["FaultEvent", "FaultTolerantLoop", "HeartbeatMonitor",
           "StragglerMitigator"]
