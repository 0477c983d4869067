"""Runtime: heartbeat/straggler monitoring + restart policy."""

from repro_torch.runtime.monitor import (HeartbeatMonitor, MonitorConfig,
                                         RestartPolicy, StepTimer)

__all__ = ["HeartbeatMonitor", "MonitorConfig", "RestartPolicy", "StepTimer"]
