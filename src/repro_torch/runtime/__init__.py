from repro_torch.runtime.faults import (FaultInjector, FaultPlan, FaultSpec,
                                        TransientOpError)
from repro_torch.runtime.ft import StepWatchdog

__all__ = ["FaultInjector", "FaultPlan", "FaultSpec", "StepWatchdog",
           "TransientOpError"]
