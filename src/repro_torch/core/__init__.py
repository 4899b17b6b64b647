# The paper's primary contribution: Performance Trace Table (PTT) +
# criticality-aware performance-based scheduling on elastic places.  The
# threaded runtime and its kernel bodies live in ``.runtime`` and
# ``.real_kernels`` (imported from there, so this package stays light).
from .dag import (KernelType, RandomDAGConfig, TaskDAG, TaskNode, chain_dag,
                  generate_random_dag, is_critical_child, paper_fig1_dag)
from .places import ClusterLayout, Place, divisor_widths, homogeneous_layout
from .ptt import (EMASearchMixin, PTT, PTTConfig, make_ptt_array,
                  ptt_global_search, ptt_local_search, ptt_update)
from .scheduler import (HomogeneousScheduler, PerformanceBasedScheduler,
                        SchedulingPolicy)
from .tracetable import (Candidate, CostModel, GlobalSearch, Latency,
                         MigrationCost, Occupancy, QueueAware, RankedSearch,
                         SearchContext, SearchPolicy, StickySearch, Sum,
                         TraceTable)

__all__ = [
    "KernelType", "RandomDAGConfig", "TaskDAG", "TaskNode", "chain_dag",
    "generate_random_dag", "is_critical_child", "paper_fig1_dag",
    "ClusterLayout", "Place", "divisor_widths", "homogeneous_layout",
    "EMASearchMixin", "PTT", "PTTConfig", "make_ptt_array", "ptt_global_search",
    "ptt_local_search", "ptt_update",
    "HomogeneousScheduler", "PerformanceBasedScheduler", "SchedulingPolicy",
    "Candidate", "CostModel", "GlobalSearch", "Latency", "MigrationCost",
    "Occupancy", "QueueAware", "RankedSearch", "SearchContext",
    "SearchPolicy", "StickySearch", "Sum", "TraceTable",
]
