"""Elastic places: resource partitions of consecutive cores (paper §3.1).

A place is a set of ``width`` consecutive cores inside one core-cluster
(cores sharing an LLC / NUMA domain — what hwloc reports).  Widths must be
natural divisors of the cluster size, and the leader (smallest id) must be
aligned to the width *within the cluster*, so partitions never straddle
cluster boundaries.  At pod scale the same object describes contiguous device
groups on the `model` mesh axis.
"""

from __future__ import annotations

import dataclasses


def divisor_widths(n: int, pow2_only: bool = False) -> tuple[int, ...]:
    ws = [w for w in range(1, n + 1) if n % w == 0]
    if pow2_only:
        ws = [w for w in ws if w & (w - 1) == 0]
    return tuple(ws)


@dataclasses.dataclass(frozen=True)
class Place:
    leader: int
    width: int

    @property
    def cores(self) -> tuple[int, ...]:
        return tuple(range(self.leader, self.leader + self.width))

    def __contains__(self, core: int) -> bool:
        return self.leader <= core < self.leader + self.width


@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """Cluster structure (from hwloc in the real system; from the platform
    model here).  Encapsulates every validity rule about places."""
    clusters: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        for cl in self.clusters:
            if list(cl) != list(range(cl[0], cl[0] + len(cl))):
                raise ValueError(f"cluster cores must be consecutive: {cl}")

    @property
    def num_cores(self) -> int:
        return sum(len(c) for c in self.clusters)

    def cluster_of(self, core: int) -> int:
        for ci, cl in enumerate(self.clusters):
            if cl[0] <= core <= cl[-1]:
                return ci
        raise ValueError(f"core {core} not in any cluster")

    def widths(self) -> tuple[int, ...]:
        ws: set[int] = set()
        for cl in self.clusters:
            ws |= set(divisor_widths(len(cl)))
        return tuple(sorted(ws))

    def valid_places(self) -> tuple[Place, ...]:
        out = []
        for cl in self.clusters:
            base, n = cl[0], len(cl)
            for w in divisor_widths(n):
                for k in range(0, n, w):
                    out.append(Place(leader=base + k, width=w))
        return tuple(out)

    def is_valid(self, place: Place) -> bool:
        ci = self.cluster_of(place.leader)
        cl = self.clusters[ci]
        base, n = cl[0], len(cl)
        return (n % place.width == 0
                and (place.leader - base) % place.width == 0
                and place.leader + place.width - 1 <= cl[-1])

    def place_of(self, core: int, width: int) -> Place:
        """The width-``width`` partition containing ``core`` (clamped to the
        widest valid width if the cluster is smaller)."""
        cl = self.clusters[self.cluster_of(core)]
        base, n = cl[0], len(cl)
        if n % width != 0 or width > n:
            # clamp to the largest valid width <= requested
            width = max(w for w in divisor_widths(n) if w <= width)
        return Place(leader=base + ((core - base) // width) * width,
                     width=width)


def homogeneous_layout(num_cores: int) -> ClusterLayout:
    return ClusterLayout(clusters=(tuple(range(num_cores)),))
