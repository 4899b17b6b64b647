"""Quickstart: the paper in 60 seconds.

Runs a random mixed-kernel TAO-DAG through both schedulers on the Jetson TX2
model and prints the speedup of the PTT-driven performance-based scheduler
over the homogeneous work-stealing baseline (paper Fig. 7).  The times are
the simulator's virtual time, not measurements of any device.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The port's counterpart of ``examples/quickstart.py``: the same DAGs, seeds
and output, through :mod:`repro_torch.sim`.
"""

import numpy as np

from repro_torch.core import (HomogeneousScheduler, KernelType,
                              PerformanceBasedScheduler, RandomDAGConfig,
                              chain_dag, generate_random_dag)
from repro_torch.sim import XiTAOSim, jetson_tx2


def main() -> dict:
    """Print the walkthrough; return ``{label: speedup}``."""
    tx2 = jetson_tx2()
    layout = tx2.layout()
    print(f"platform: {tx2.name} clusters={tx2.clusters}")
    print(f"valid places (leader,width): "
          f"{[(p.leader, p.width) for p in layout.valid_places()]}\n")

    out = {}
    for label, dag_f in [
            ("matmul chain (par=1)",
             lambda s: chain_dag(KernelType.MATMUL, 300)),
            ("mixed random DAG (par~4)",
             lambda s: generate_random_dag(RandomDAGConfig(
                 tasks_per_kernel={k: 150 for k in (
                     KernelType.MATMUL, KernelType.SORT, KernelType.COPY)},
                 avg_width=4, edge_rate=2.0, seed=s)))]:
        hom, perf = [], []
        for s in range(4):
            hom.append(XiTAOSim(tx2, HomogeneousScheduler(layout),
                                seed=s).run(dag_f(s)).throughput)
            pol = PerformanceBasedScheduler(layout, 4)
            perf.append(XiTAOSim(tx2, pol, seed=s).run(dag_f(s)).throughput)
        out[label] = np.mean(perf) / np.mean(hom)
        print(f"{label:28s} homogeneous={np.mean(hom):6.2f} tasks/s  "
              f"performance-based={np.mean(perf):6.2f} tasks/s  "
              f"speedup={out[label]:.2f}x")

    print("\ntrained PTT for MATMUL (rows=cores, cols=widths",
          layout.widths(), "):")
    print(np.round(pol.ptt.table(0), 3))
    return out


if __name__ == "__main__":
    main()
