from repro_torch.runtime.ft import (HeartbeatMonitor, StepWatchdog,
                                    StragglerDetector, RestartPolicy,
                                    run_with_restarts)
from repro_torch.runtime.faults import (FaultInjector, FaultPlan, FaultSpec,
                                        TransientOpError)
from repro_torch.runtime.compression import (topk_compress, topk_decompress,
                                             ErrorFeedbackState,
                                             compress_grads_with_feedback,
                                             int8_compress, int8_decompress)

__all__ = [
    "FaultInjector", "FaultPlan", "FaultSpec", "TransientOpError",
    "HeartbeatMonitor", "StepWatchdog", "StragglerDetector",
    "RestartPolicy", "run_with_restarts", "topk_compress",
    "topk_decompress", "ErrorFeedbackState",
    "compress_grads_with_feedback", "int8_compress", "int8_decompress",
]
