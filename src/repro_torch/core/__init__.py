# The paper's Performance Trace Table and the places it searches over (the
# numpy parts of repro.core that the serving scheduler needs).
from .places import ClusterLayout, Place, divisor_widths, homogeneous_layout
from .ptt import EMASearchMixin, PTT, PTTConfig
from .tracetable import (Candidate, CostModel, GlobalSearch, Latency,
                         MigrationCost, Occupancy, QueueAware, RankedSearch,
                         SearchContext, SearchPolicy, StickySearch, Sum,
                         TraceTable)

__all__ = [
    "ClusterLayout", "Place", "divisor_widths", "homogeneous_layout",
    "EMASearchMixin", "PTT", "PTTConfig",
    "Candidate", "CostModel", "GlobalSearch", "Latency", "MigrationCost",
    "Occupancy", "QueueAware", "RankedSearch", "SearchContext",
    "SearchPolicy", "StickySearch", "Sum", "TraceTable",
]
