from .engine import Assignment, SimResult, TaskRecord, XiTAOSim, run_policy
from .platform import (ContentionState, DVFSEvent, InterferenceWindow,
                       PlatformModel, haswell_2650v3, jetson_tx2,
                       tpu_pod_places)

__all__ = [
    "Assignment", "SimResult", "TaskRecord", "XiTAOSim", "run_policy",
    "ContentionState", "DVFSEvent", "InterferenceWindow", "PlatformModel",
    "haswell_2650v3", "jetson_tx2", "tpu_pod_places",
]
