"""Find the knee of an open-loop cell: its window run at a few offered
rates, one process, one set of weights, a new engine a rate.

    python portbench/sweep.py --workload <open-loop cell> --rates 12,16,20 --seconds 10 --seed 5

Prints one JSON line a rate: the rate, the end-to-end tails, and the
backlog (requests queued or prefilling) through the window, as its means
over the first and last thirds and its least-squares slope in requests a
second.  The knee is the highest rate whose backlog does not grow through
the window; a cell's traffic file holds 0.8 x the knee.  Nothing is
compared with the reference: this is no benchmark run."""

from __future__ import annotations

import argparse
import json
import sys
import time

T_START = time.perf_counter()

import run as harness  # noqa: E402  (portbench/run.py, beside this file)


def slope(points) -> float:
    n = len(points)
    mt = sum(t for t, _ in points) / n
    mb = sum(b for _, b in points) / n
    var = sum((t - mt) ** 2 for t, _ in points)
    return sum((t - mt) * (b - mb) for t, b in points) / var if var else 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    harness._paths()
    from portbench.drivers import serve_open
    from portbench.lib import cell, device, serving
    from portbench.lib import model as M
    work, conf, traffic, limits = cell.load_cell(args.workload)
    dev = device.require(work["chips"])
    ctx = cell.Context(cell=args.workload, conf=conf, traffic=traffic,
                       limits=limits, dims=M.dims(conf), seed=args.seed,
                       seconds=args.seconds, trace=False, device=dev,
                       t_start=T_START)
    model, params = cell.build_program(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        out = serve_open.serve(ctx, model, params, rate)
        loop = out["loop"]
        pts = loop.backlog
        third = max(1, len(pts) // 3)
        ttft, missing = loop.ttfts()
        print(json.dumps({
            "rate": rate, "requests": out["n"], "unserved": missing,
            "ttft_p95_ms": serving.p95_ms(ttft),
            "ttft_p50_ms": None if not ttft else 1e3 * sorted(ttft)[
                len(ttft) // 2],
            "tpot_p95_ms": serving.p95_ms(loop.tpots(out["t0"],
                                                     out["t_close"])),
            "backlog_first": sum(b for _, b in pts[:third]) / third,
            "backlog_last": sum(b for _, b in pts[-third:]) / third,
            "backlog_slope": slope(pts), "steps": len(pts)}), flush=True)
        loop.close()
        del out, loop
        cell.free_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
