from .elastic import (HeartbeatMonitor, PodPTT, RooflineLatencyModel,
                      StragglerRebalancer, elastic_remesh)
from .sharding import (AxisRules, constrain, current_rules, logical_sharding,
                       set_rules, spec_for, use_rules)

__all__ = ["AxisRules", "constrain", "current_rules", "logical_sharding",
           "set_rules", "spec_for", "use_rules", "HeartbeatMonitor",
           "PodPTT", "RooflineLatencyModel", "StragglerRebalancer",
           "elastic_remesh"]
