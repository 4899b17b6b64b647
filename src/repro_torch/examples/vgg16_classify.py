"""Paper §4.3: VGG-16 through the XiTAO runtime.

Two parts:
1. strong-scaling study on the Haswell model (paper Fig. 9: 0.69 efficiency
   at 20 threads) using the simulator; its times are virtual time, not
   measurements of any device;
2. a REAL reduced-VGG forward pass executed by the threaded XiTAO runtime,
   each layer partitioned into GEMM TAOs (im2col), every TAO body running
   the port's matmul (``kernels/matmul/csrc/matmul.cu`` on the card, its
   plain version on the CPU) and a ReLU into its block; then one
   representative layer held against ``matmul_ref``.

    PYTHONPATH=src python -m repro_torch.examples.vgg16_classify [--device cpu]

The port's counterpart of ``examples/vgg16_classify.py``, at its shapes:
four im2col GEMM layers over 256 patches, 2 TAOs a layer, 2 workers, and
the weights drawn from ``np.random.default_rng(0)`` in the reference's
order (the draw the reference makes for its unused ``ref`` included), so
the activations are the reference's.  Each TAO's weight block is made
contiguous when the DAG is built; its body writes rows ``[r0, r1)`` of its
column block ``a_out[:, lo:hi]`` in place through the op's ``out=`` (the
kernel takes any row stride) on its worker's own stream and waits, so the
PTT learns device time.  Each body chunk is one matmul launch, so the
launches of a run equal the sum of the widths the runtime chose.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (KernelType, PerformanceBasedScheduler, TaskDAG,
                              TaskNode, homogeneous_layout)
from repro_torch.core.real_kernels import WorkerStreams
from repro_torch.core.runtime import ThreadedRuntime
from repro_torch.device import resolve_device
from repro_torch.kernels.matmul import matmul, matmul_ref
from repro_torch.sim import XiTAOSim, haswell_2650v3
from repro_torch.sim.platform import restrict_platform
from repro_torch.sim.vgg16 import VGGConfig, vgg16_dag

# (K, Cout) of the reference's four im2col layers; as in the reference, a
# layer's weight has ``acts[-1].shape[1]`` rows, not K
LAYERS = ((27, 16), (144, 32), (288, 64), (576, 64))
PATCHES = 256
TAOS_PER_LAYER = 2
WORKERS = 2


def scaling_study() -> list[tuple[int, float, float]]:
    """Print and return ``(threads, makespan, efficiency)`` rows."""
    print("=== VGG-16 strong scaling (simulated Haswell, paper Fig. 9) ===")
    hw = haswell_2650v3()
    t1 = None
    rows = []
    for n in (1, 2, 4, 8, 16, 20):
        p = restrict_platform(hw, n)
        pol = PerformanceBasedScheduler(p.layout(), 4)
        r = XiTAOSim(p, pol, seed=0, force_noncritical=True).run(
            vgg16_dag(VGGConfig()))
        t1 = t1 or r.makespan
        rows.append((n, r.makespan, t1 / (n * r.makespan)))
        print(f"  threads={n:2d} time={r.makespan:7.2f} "
              f"eff={t1/(n*r.makespan):.2f}")
    return rows


def build_forward(device, rng: np.random.Generator, chunks: list):
    """The reduced forward as a TAO-DAG: returns ``(dag, bodies, acts,
    weights)`` with ``acts[0]`` the input patches, ``acts[i + 1]`` layer
    i's output (zeros until the run), ``weights[i]`` its (rows, Cout)
    weight, all on ``device``.  Each body chunk appends its matmul's
    ``(rows of the input, weight block, output block)`` to ``chunks``."""
    x = rng.standard_normal((PATCHES, LAYERS[0][0])).astype(np.float32)
    acts = [torch.from_numpy(x).to(device)]
    weights = []
    run = WorkerStreams(device)
    nodes, bodies = [], {}
    prev_ids: list[int] = []
    for _, C in LAYERS:
        w = rng.standard_normal((acts[-1].shape[1], C)).astype(np.float32)
        weights.append(torch.from_numpy(w).to(device))
        a_in = acts[-1]
        a_out = torch.zeros((a_in.shape[0], C), dtype=torch.float32,
                            device=device)
        acts.append(a_out)
        ids = []
        for t in range(TAOS_PER_LAYER):
            nid = len(nodes)
            node = TaskNode(nid=nid, kernel=KernelType.GEMM, work=1.0)
            lo = t * C // TAOS_PER_LAYER
            hi = (t + 1) * C // TAOS_PER_LAYER
            w_blk = torch.from_numpy(np.ascontiguousarray(w[:, lo:hi])).to(
                device)

            def body(chunk, width, a_in=a_in, w_blk=w_blk, a_out=a_out,
                     lo=lo, hi=hi):
                rows = a_in.shape[0]
                r0, r1 = chunk * rows // width, (chunk + 1) * rows // width

                def launch():
                    blk = a_out[r0:r1, lo:hi]
                    matmul(a_in[r0:r1], w_blk, out=blk)
                    blk.clamp_(min=0.0)
                    chunks.append((a_in[r0:r1], w_blk, blk))
                run(launch)
            for p in prev_ids:
                nodes[p].children.append(nid)
                node.parents.append(p)
            nodes.append(node)
            bodies[nid] = body
            ids.append(nid)
        prev_ids = ids
    if device.type == "cuda":
        torch.cuda.synchronize(device)    # the inputs are there for any stream
    return TaskDAG(nodes), bodies, acts, weights


def plain_forward(acts0: torch.Tensor, weights) -> list[torch.Tensor]:
    """The same forward through ``matmul_ref`` (whole layers, no TAOs)."""
    acts = [acts0]
    for w in weights:
        acts.append(matmul_ref(acts[-1], w).clamp(min=0.0))
    return acts


def real_forward(device=None) -> dict:
    """Run the reduced forward through the threaded runtime; print the
    reference's lines; return the activations, weights, placements, the
    body chunks' matmul operands (one a launch, in the order they ran) and
    the representative layer's result."""
    print("\n=== real reduced-VGG forward through the threaded runtime ===")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    chunks: list = []
    dag, bodies, acts, weights = build_forward(dev, rng, chunks)
    layout = homogeneous_layout(WORKERS)
    pol = PerformanceBasedScheduler(layout, 4)
    placements = ThreadedRuntime(pol, num_workers=WORKERS, seed=0).run(
        dag, bodies, timeout=60)
    last = acts[-1][0].cpu().numpy()
    z = last - last.max()                       # stable softmax
    probs = np.exp(z) / np.exp(z).sum()
    print(f"  executed {len(dag.nodes)} GEMM TAOs across {len(LAYERS)} "
          f"layers")
    print(f"  'class' prediction: argmax={probs.argmax()} "
          f"p={probs.max():.3f}")
    # the reference's draw for its unused ``ref`` keeps the stream aligned
    rng.standard_normal((27, 64))
    x = acts[0][:128, :16]
    y = torch.eye(16, 128, dtype=torch.float32, device=dev)
    got = matmul(x, y)
    ok = bool(torch.allclose(got, matmul_ref(x, y), atol=1e-4))
    print(f"  matmul kernel ({dev.type}) matches matmul_ref: {ok}")
    return {"acts": acts, "weights": weights, "placements": placements,
            "ptt": pol.ptt, "probs": probs, "chunks": chunks,
            "representative_ok": ok, "representative": (x, y, got)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    scaling_study()
    real_forward(args.device)


if __name__ == "__main__":
    main()
