"""VGG-16 as a TAO-DAG (paper §4.3).

Each CONV/FC layer is GEMM work partitioned into TAOs along output channels
(`block_len` channels per TAO, the paper's runtime-tuned parameter).  There
are no loop-carried dependencies inside a layer, but every layer depends on
the previous one, so consecutive layers are joined by a barrier (all-to-all
edges), exactly as the paper's port synchronizes TAOs at layer boundaries.

All tasks are marked non-critical in this experiment (paper §5.4: "there is
no criticality notion to this experiment").  Work units are GFLOPs.

This is the PyTorch port's copy of ``repro.sim.vgg16``.
"""

from __future__ import annotations

import dataclasses

from ..core.dag import KernelType, TaskDAG, TaskNode

# (kind, out_channels, spatial) for 224x224 input; 13 convs + 3 FC.
VGG16_LAYERS: tuple[tuple[str, int, int], ...] = (
    ("conv", 64, 224), ("conv", 64, 224),
    ("conv", 128, 112), ("conv", 128, 112),
    ("conv", 256, 56), ("conv", 256, 56), ("conv", 256, 56),
    ("conv", 512, 28), ("conv", 512, 28), ("conv", 512, 28),
    ("conv", 512, 14), ("conv", 512, 14), ("conv", 512, 14),
    ("fc", 4096, 1), ("fc", 4096, 1), ("fc", 1000, 1),
)

_IN_CHANNELS = (3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                512 * 7 * 7, 4096, 4096)


def layer_gflops(idx: int) -> float:
    kind, cout, hw = VGG16_LAYERS[idx]
    cin = _IN_CHANNELS[idx]
    if kind == "conv":
        return 2.0 * hw * hw * cin * cout * 9 / 1e9
    return 2.0 * cin * cout / 1e9


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    # output channels per TAO; the paper tunes this at runtime — 4 is the
    # tuned point for the 20-core Haswell strong-scaling study
    block_len: int = 4
    min_taos: int = 1


def vgg16_dag(cfg: VGGConfig = VGGConfig()) -> TaskDAG:
    nodes: list[TaskNode] = []
    prev_layer: list[int] = []
    for li, (kind, cout, _hw) in enumerate(VGG16_LAYERS):
        n_taos = max(cfg.min_taos, (cout + cfg.block_len - 1) // cfg.block_len)
        work = layer_gflops(li) / n_taos
        cur: list[int] = []
        for _ in range(n_taos):
            nid = len(nodes)
            node = TaskNode(nid=nid, kernel=KernelType.GEMM, work=work)
            for p in prev_layer:               # layer barrier
                nodes[p].children.append(nid)
                node.parents.append(p)
            nodes.append(node)
            cur.append(nid)
        prev_layer = cur
    return TaskDAG(nodes)


def total_gflops() -> float:
    return sum(layer_gflops(i) for i in range(len(VGG16_LAYERS)))
