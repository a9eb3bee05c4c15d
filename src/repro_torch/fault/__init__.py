# repro_torch.fault — straggler detection (the port's copy of
# repro.fault.stragglers). The fault-tolerant training runner belongs to
# the training substrate and is not ported.
from repro_torch.fault.stragglers import HostTimingAggregator, StragglerMonitor

__all__ = ["HostTimingAggregator", "StragglerMonitor"]
