"""Time ``ragged_decode`` kernel by kernel in this checkout and in another
one, on the card, to compare two versions of it in one call.

    python -m repro_torch.kernels.ragged_decode.compare OTHER_ROOT

``OTHER_ROOT`` is the root of another checkout of the repo (its ``src``
holds a ``repro_torch``; unpack one with ``git archive``).  The runs go
other, this, this, other, each in a process of its own with that tree's
``src`` first on the path: the process builds that tree's kernels and
calls ``ragged_decode_attention`` without the log-sum-exp at the serving
path's shape (qwen2-0.5b's 14 / 2 heads, hd 64, bfloat16, 8 slots, Smax
2048, mixed positions), each call after an L2 flush.  It reports the mean
device time of the split pass and of the combine under ``torch.profiler``
and the mean time of a whole call between CUDA events.  Prints one JSON
line a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ITERS = 200
POS = [0, 100, 511, 1024, 1500, 2047, 3000, 777]


def _worker(iters: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ragged_decode import ops

    B, Smax, Hq, Hkv, hd = 8, 2048, 14, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    q, k, v = randn(B, Hq, hd), randn(B, Smax, Hkv, hd), randn(
        B, Smax, Hkv, hd)
    pos = torch.tensor(POS, dtype=torch.int32, device="cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def call():
        return ops.ragged_decode_attention(q, k, v, pos)
    for _ in range(10):                       # build, load, warm up
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    kernels = {"split": [0.0, 0], "combine": [0.0, 0]}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        for name in kernels:
            if f"decode_{name}" in e.key:
                kernels[name][0] += us
                kernels[name][1] += e.count
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        call()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    out = {f"{n}_us": us / c if c else None
           for n, (us, c) in kernels.items()}
    out.update({f"{n}_launches": c for n, (_, c) in kernels.items()})
    out["call_ms"] = total / iters
    return out


def _run(root: pathlib.Path, iters: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    done = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
         "--iters", str(iters)], env=env, cwd=root, capture_output=True,
        text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"run in {root} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", type=pathlib.Path)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.iters)))
        return 0
    if args.other is None:
        ap.error("the other checkout's root is required")
    here = pathlib.Path(__file__).resolve().parents[4]
    trees = {"other": args.other.resolve(), "this": here}
    for label in ("other", "this", "this", "other"):
        row = dict(tree=label, root=str(trees[label]),
                   **_run(trees[label], args.iters))
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
