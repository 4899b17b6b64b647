"""Platform models for the discrete-event XiTAO simulator.

The container has one CPU device, so the paper's heterogeneous platforms are
modeled analytically and executed in virtual time.  The models are calibrated
from the paper's own kernel descriptions (§4.2.1) and hardware specs:

* **Jetson TX2** — cores 0-1: NVIDIA Denver2 (wide 7-way superscalar, fast on
  dense compute), cores 2-5: ARM A57 complex.  Each cluster has a 2 MB L2.
  Single shared LPDDR4 DRAM: streaming kernels contend for bandwidth; a
  single core cannot saturate it (width scaling > 1 for copy).
* **Intel Haswell 2650v3 x2** — 20 identical cores in 2 NUMA clusters of 10,
  used for interference and VGG-16 experiments.

Execution-time model for a TAO of kernel k, work W, at place (leader, width w):

    share_i = W * f_i / E(k, w)          per-core work share
    t_i     = share_i / (speed(core_i, k) * dyn(core_i, t))

where E(k, w) is the kernel's width-scaling efficiency (sort caps at 4-way;
copy follows a bandwidth-saturation curve; a cache-resident sort is mildly
superlinear at w=2 because the split working set fits L2 comfortably) and
dyn() folds dynamic effects (interference windows, DVFS) — the *sources of
heterogeneity* the PTT is supposed to discover.  Worker cores grab chunks
dynamically, so the leader's share f_leader is slightly below 1/w (the
leader-measurement skew discussed in paper §3.2).

This is the PyTorch port's copy of ``repro.sim.platform``.  The simulator
needs no torch: it is numpy in virtual time, and its random draws come
from ``np.random.default_rng`` in the reference's order, so the port's
simulations equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.dag import KernelType
from ..core.places import ClusterLayout


@dataclasses.dataclass(frozen=True)
class InterferenceWindow:
    """A background process time-sharing `cores` during [t0, t1)."""
    cores: tuple[int, ...]
    t0: float
    t1: float
    slowdown: float = 3.0

    def active(self, core: int, t: float) -> bool:
        return core in self.cores and self.t0 <= t < self.t1


@dataclasses.dataclass(frozen=True)
class DVFSEvent:
    """Core clock scaled by `factor` during [t0, t1) (dynamic heterogeneity)."""
    cores: tuple[int, ...]
    t0: float
    t1: float
    factor: float = 0.5


@dataclasses.dataclass
class PlatformModel:
    name: str
    num_cores: int
    clusters: tuple[tuple[int, ...], ...]        # cores sharing an LLC
    # speed[kernel][core]: work units / second
    speed: dict[KernelType, np.ndarray]
    # width-scaling efficiency E(k, w): dict kernel -> {width: efficiency}
    width_eff: dict[KernelType, dict[int, float]]
    l2_bytes: int = 2 * 1024 * 1024
    sort_ws_bytes: int = 524 * 1024              # paper: 262KB double-buffered
    interference: list[InterferenceWindow] = dataclasses.field(default_factory=list)
    dvfs: list[DVFSEvent] = dataclasses.field(default_factory=list)
    leader_share_skew: float = 0.06              # leader grabs slightly less
    noise: float = 0.03                          # run-to-run timing jitter
    _rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(1234), repr=False)

    def reseed(self, seed: int) -> None:
        object.__setattr__(self, "_rng", np.random.default_rng(seed))

    # -- helpers -----------------------------------------------------------
    def layout(self) -> ClusterLayout:
        return ClusterLayout(clusters=self.clusters)

    def cluster_of(self, core: int) -> int:
        for ci, cl in enumerate(self.clusters):
            if core in cl:
                return ci
        raise ValueError(core)

    def widths_for_cluster(self, ci: int) -> tuple[int, ...]:
        n = len(self.clusters[ci])
        return tuple(w for w in range(1, n + 1) if n % w == 0)

    def valid_widths(self) -> tuple[int, ...]:
        ws: set[int] = set()
        for ci in range(len(self.clusters)):
            ws |= set(self.widths_for_cluster(ci))
        return tuple(sorted(ws))

    def dyn_factor(self, core: int, t: float) -> float:
        f = 1.0
        for w in self.interference:
            if w.active(core, t):
                f /= w.slowdown
        for d in self.dvfs:
            if core in d.cores and d.t0 <= t < d.t1:
                f *= d.factor
        return f

    def eff(self, kernel: KernelType, width: int) -> float:
        table = self.width_eff[kernel]
        if width in table:
            return table[width]
        # interpolate between calibrated widths; flat beyond the last point
        ks = sorted(table)
        if width <= ks[0]:
            return table[ks[0]]
        if width >= ks[-1]:
            return table[ks[-1]]
        import bisect
        j = bisect.bisect_left(ks, width)
        lo, hi = ks[j - 1], ks[j]
        f = (width - lo) / (hi - lo)
        return table[lo] + f * (table[hi] - table[lo])

    # -- the execution-time model -------------------------------------------
    def shares(self, width: int) -> np.ndarray:
        """Work fractions per member core; leader (index 0) slightly below
        1/w because workers grab chunks dynamically (paper §3.2 skew)."""
        if width == 1:
            return np.ones(1)
        f = np.full(width, 1.0 / width)
        delta = self.leader_share_skew / width
        f[0] -= delta
        f[1:] += delta / (width - 1)
        return f

    def durations(self, kernel: KernelType, work: float, leader: int,
                  width: int, t: float,
                  contention: "ContentionState | None" = None) -> np.ndarray:
        """Per-member-core execution times for one TAO."""
        eff = self.eff(kernel, width)
        penalty = 1.0
        if contention is not None:
            penalty = contention.penalty(self, kernel, leader, width)
        shares = self.shares(width)
        out = np.empty(width)
        for i in range(width):
            core = leader + i
            sp = self.speed[kernel][core] * self.dyn_factor(core, t)
            out[i] = (work * shares[i] * width / eff) * penalty / sp
        if self.noise > 0.0:    # real measurements jitter (paper Fig. 8)
            out *= 1.0 + self.noise * (2.0 * self._rng.random(width) - 1.0)
        return out


class ContentionState:
    """Tracks concurrently-active TAOs per cluster to model cache- and
    bandwidth-oversubscription (the interference the PTT must learn around).

    * sort: combined working sets above the cluster L2 -> capacity penalty.
    * copy: concurrent streams share DRAM bandwidth.
    Counters are sampled at task start (deterministic, no mid-flight
    re-pricing) — adequate for the trends the paper reports.
    """

    def __init__(self, platform: PlatformModel):
        self.platform = platform
        ncl = len(platform.clusters)
        self.active_sort = np.zeros(ncl, dtype=int)
        self.active_copy = np.zeros(ncl, dtype=int)
        self.active_any = np.zeros(ncl, dtype=int)

    def begin(self, kernel: KernelType, leader: int) -> None:
        ci = self.platform.cluster_of(leader)
        self.active_any[ci] += 1
        if kernel == KernelType.SORT:
            self.active_sort[ci] += 1
        elif kernel == KernelType.COPY:
            self.active_copy[ci] += 1

    def end(self, kernel: KernelType, leader: int) -> None:
        ci = self.platform.cluster_of(leader)
        self.active_any[ci] -= 1
        if kernel == KernelType.SORT:
            self.active_sort[ci] -= 1
        elif kernel == KernelType.COPY:
            self.active_copy[ci] -= 1

    def penalty(self, platform: PlatformModel, kernel: KernelType,
                leader: int, width: int) -> float:
        ci = platform.cluster_of(leader)
        pen = 1.0
        if kernel == KernelType.SORT:
            concurrent = self.active_sort[ci] + 1
            ws = concurrent * platform.sort_ws_bytes
            if ws > platform.l2_bytes:
                pen *= 1.0 + 0.6 * (ws / platform.l2_bytes - 1.0)
        elif kernel == KernelType.COPY:
            streams = self.active_copy[ci] + 1
            if streams > 1:                       # shared-DRAM slowdown
                pen *= 1.0 + 0.45 * (streams - 1)
        # wide TAOs on a busy cluster pay fork/join + LLC co-run overhead;
        # at low concurrency wide stays cheap (the paper's critical-task
        # regime), under load width-1 wins (the paper's Fig.10 regime)
        if width > 1:
            pen *= 1.0 + 0.06 * min(int(self.active_any[ci]), 3)
        return pen


def restrict_platform(p: PlatformModel, n: int) -> PlatformModel:
    """First-n-cores view for strong-scaling studies (paper Fig. 9)."""
    clusters = []
    for cl in p.clusters:
        kept = tuple(c for c in cl if c < n)
        if kept:
            clusters.append(kept)
    return dataclasses.replace(
        p, name=f"{p.name}-n{n}", num_cores=n, clusters=tuple(clusters),
        speed={k: v[:n].copy() for k, v in p.speed.items()})


# ---------------------------------------------------------------------------
# Calibrated platforms
# ---------------------------------------------------------------------------

def _speeds(num_cores: int, fast: tuple[int, ...],
            fast_speed: float) -> np.ndarray:
    s = np.ones(num_cores)
    s[list(fast)] = fast_speed
    return s


def jetson_tx2() -> PlatformModel:
    """2x Denver2 (cores 0,1) + 4x A57 (cores 2-5).  Denver/A57 speed ratios
    per kernel and width-scaling efficiencies calibrated to land the paper's
    Fig. 7 speedups (3.3x matmul / 2.5x sort / 2.2x copy / 2.7x mix @ par=1)."""
    n = 6
    return PlatformModel(
        name="jetson-tx2",
        num_cores=n,
        clusters=((0, 1), (2, 3, 4, 5)),
        speed={
            KernelType.MATMUL: _speeds(n, (0, 1), 2.6),
            KernelType.SORT: _speeds(n, (0, 1), 1.45),
            KernelType.COPY: _speeds(n, (0, 1), 1.45),
            KernelType.GEMM: _speeds(n, (0, 1), 2.6),
        },
        width_eff={
            # dense 64x64 matmul scales nearly linearly to small widths
            KernelType.MATMUL: {1: 1.0, 2: 1.95, 3: 2.8, 4: 3.6, 6: 4.8},
            # quick+merge sort: max parallelism 4 (paper); mildly superlinear
            # at w=2 (split working set fits L2 comfortably)
            KernelType.SORT: {1: 1.0, 2: 2.1, 3: 2.9, 4: 3.3, 6: 3.3},
            # streaming copy: one core cannot saturate LPDDR4; saturates ~2-3
            KernelType.COPY: {1: 1.0, 2: 1.95, 3: 2.2, 4: 2.3, 6: 2.3},
            KernelType.GEMM: {1: 1.0, 2: 1.95, 3: 2.8, 4: 3.6, 6: 4.8},
        },
    )


def haswell_2650v3() -> PlatformModel:
    """2-socket, 10 homogeneous cores each (paper's interference/VGG box)."""
    n = 20
    ident = np.ones(n)
    gemm_eff = {1: 1.0, 2: 1.95, 5: 4.6, 10: 8.3}
    return PlatformModel(
        name="haswell-2650v3",
        num_cores=n,
        clusters=(tuple(range(10)), tuple(range(10, 20))),
        speed={k: ident.copy() for k in KernelType},
        width_eff={
            KernelType.MATMUL: gemm_eff,
            KernelType.SORT: {1: 1.0, 2: 2.0, 5: 3.6, 10: 3.6},
            KernelType.COPY: {1: 1.0, 2: 1.8, 5: 2.6, 10: 2.6},
            KernelType.GEMM: gemm_eff,
        },
        l2_bytes=25 * 1024 * 1024,   # 25MB LLC per socket
    )


def tpu_pod_places(num_groups: int = 16, slow_groups: tuple[int, ...] = (),
                   slow_factor: float = 0.7) -> PlatformModel:
    """Pod-scale abstraction: 'cores' are device groups on the model axis
    (one row each), widths are powers of two.  Per-group latencies are seeded
    from the dry-run roofline terms by the caller; `slow_groups` models a
    straggling slice (thermal/co-tenant).  Used by the elastic-serving and
    straggler benchmarks.  The name is the reference's, kept so a reader
    finds it; its constants are the reference's model parameters, not
    measurements of any card."""
    n = num_groups
    speed = np.ones(n)
    speed[list(slow_groups)] = slow_factor
    pow2 = {w: float(w) * 0.92 for w in (1, 2, 4, 8, 16) if w <= n}
    pow2[1] = 1.0
    return PlatformModel(
        name=f"tpu-pod-{n}g",
        num_cores=n,
        clusters=(tuple(range(n)),),
        speed={k: speed.copy() for k in KernelType},
        width_eff={k: dict(pow2) for k in KernelType},
        l2_bytes=1 << 62,            # no cache modelling at this level
    )
