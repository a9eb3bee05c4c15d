# repro_torch.fault — the fault-tolerant training runner and straggler
# detection (the port's copies of repro.fault).
from repro_torch.fault.runner import FaultTolerantRunner, RunnerConfig
from repro_torch.fault.stragglers import HostTimingAggregator, StragglerMonitor

__all__ = ["FaultTolerantRunner", "RunnerConfig", "HostTimingAggregator",
           "StragglerMonitor"]
