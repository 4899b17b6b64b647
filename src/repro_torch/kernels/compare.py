"""Time one of the port's attention kernels kernel by kernel in this
checkout and in another one, on the card, to compare two versions of it
in one call.

    python -m repro_torch.kernels.compare OTHER_ROOT [--kernel NAME]

``OTHER_ROOT`` is the root of another checkout of the repo (its ``src``
holds a ``repro_torch``; unpack one with ``git archive``).  ``NAME`` is
``ragged_decode`` (the default) or ``ragged_prefill``.  The runs go
other, this, this, other, each in a process of its own with that tree's
``src`` first on the path: the process builds that tree's kernels and
calls the kernel's op without the log-sum-exp at the serving path's
shape, each call after an L2 flush: for ``ragged_decode`` qwen2-0.5b's 14
/ 2 heads, hd 64, bfloat16, 8 slots, Smax 2048, mixed positions; for
``ragged_prefill`` the same heads and cache, one slot, a chunk of 256
tokens at position 768 (``chip_smoke.py``'s timed case).  It reports the
mean device time of each of the kernel's device functions under
``torch.profiler`` and the mean time of a whole call between CUDA
events.  Prints one JSON line a run, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import subprocess
import sys

ITERS = 200
DECODE_POS = [0, 100, 511, 1024, 1500, 2047, 3000, 777]
# kernel -> {label: a substring of its device functions' names}
PARTS = {"ragged_decode": {"split": "decode_split", "combine":
                           "decode_combine"},
         "ragged_prefill": {"kernel": "prefill_bf16_wgmma"}}


def _inputs(kernel: str, torch):
    """The op's arguments at the serving path's shape."""
    Smax, Hq, Hkv, hd = 2048, 14, 2, 64
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")
    if kernel == "ragged_decode":
        B = len(DECODE_POS)
        return (randn(B, Hq, hd), randn(B, Smax, Hkv, hd),
                randn(B, Smax, Hkv, hd), i32(DECODE_POS))
    return (randn(1, 256, Hq, hd), randn(1, Smax, Hkv, hd),
            randn(1, Smax, Hkv, hd), i32([768]), i32([256]))


def _worker(kernel: str, iters: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    op = getattr(ops, f"{kernel}_attention")
    args = _inputs(kernel, torch)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def call():
        return op(*args)
    for _ in range(10):                       # build, load, warm up
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    parts = {name: [0.0, 0] for name in PARTS[kernel]}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        for name, sub in PARTS[kernel].items():
            if sub in e.key:
                parts[name][0] += us
                parts[name][1] += e.count
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
    out = {f"{n}_us": us / c if c else None for n, (us, c) in parts.items()}
    out.update({f"{n}_launches": c for n, (_, c) in parts.items()})
    out["call_ms"] = total / iters
    return out


def _run(root: pathlib.Path, kernel: str, iters: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    done = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
         "--kernel", kernel, "--iters", str(iters)], env=env, cwd=root,
        capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"run in {root} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", type=pathlib.Path)
    ap.add_argument("--kernel", choices=tuple(PARTS),
                    default="ragged_decode")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.kernel, args.iters)))
        return 0
    if args.other is None:
        ap.error("the other checkout's root is required")
    here = pathlib.Path(__file__).resolve().parents[3]
    trees = {"other": args.other.resolve(), "this": here}
    for label in ("other", "this", "this", "other"):
        row = dict(tree=label, kernel=args.kernel, root=str(trees[label]),
                   **_run(trees[label], args.kernel, args.iters))
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
