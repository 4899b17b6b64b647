"""Paper Fig. 8 scenario: a background process interferes with cores 0-1 of
the Haswell box mid-run; watch the PTT re-route critical tasks and recover.
Times are the simulator's virtual time, not measurements of any device.

    PYTHONPATH=src python -m repro_torch.examples.interference_adaptation

The port's counterpart of ``examples/interference_adaptation.py``: the same
DAG, window and output, through :mod:`repro_torch.sim`.
"""

import numpy as np

from repro_torch.core import (KernelType, PerformanceBasedScheduler,
                              RandomDAGConfig, generate_random_dag)
from repro_torch.sim import InterferenceWindow, XiTAOSim, haswell_2650v3


def main() -> dict:
    """Print the walkthrough; return both makespans and the share of
    critical tasks led from cores 0-1 in each printed window."""
    hw = haswell_2650v3()
    hw.interference.append(
        InterferenceWindow(cores=(0, 1), t0=20.0, t1=60.0, slowdown=4.0))
    dag = generate_random_dag(RandomDAGConfig(
        tasks_per_kernel={KernelType.MATMUL: 2000}, avg_width=8,
        edge_rate=2.0, seed=0))
    pol = PerformanceBasedScheduler(hw.layout(), 4)
    res = XiTAOSim(hw, pol, seed=0).run(dag)
    crit = [r for r in res.records if r.critical]
    fracs = {}
    print("time window    critical tasks    frac on interfered cores 0-1")
    for lo, hi, label in [(0, 20, "before"), (20, 60, "DURING"),
                          (60, 120, "after "), (120, 1e9, "late  ")]:
        sel = [r for r in crit if lo <= r.t_start < hi]
        if not sel:
            continue
        frac = fracs[label.strip()] = np.mean([r.leader in (0, 1)
                                               for r in sel])
        bar = "#" * int(40 * frac)
        print(f"[{label}]        {len(sel):4d}             {frac:.2f} {bar}")
    print(f"\nmakespan with interference: {res.makespan:.1f}")
    clean = XiTAOSim(haswell_2650v3(),
                     PerformanceBasedScheduler(haswell_2650v3().layout(), 4),
                     seed=0).run(dag)
    print(f"makespan without:           {clean.makespan:.1f} "
          f"(delta {100*(res.makespan/clean.makespan-1):.1f}% — paper: marginal)")
    return {"makespan": res.makespan, "clean_makespan": clean.makespan,
            "critical_on_0_1": fracs}


if __name__ == "__main__":
    main()
