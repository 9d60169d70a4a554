"""`repro_torch.runtime` — liveness and straggler machinery the serving
runtime's hooks wire in (``HeartbeatMonitor``, ``StragglerMitigator``)."""
from repro_torch.runtime.fault import FaultEvent, HeartbeatMonitor
from repro_torch.runtime.straggler import StragglerMitigator

__all__ = ["FaultEvent", "HeartbeatMonitor", "StragglerMitigator"]
