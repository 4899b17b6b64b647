"""The readings a cell's limits are set from (how ``correct`` is decided):
the program on a dozen seeds or more, and on a few of them the control
(the reference in float8 e4m3 products, the step below the program's
bfloat16) and, for a training cell, the reference in bfloat16 (a witness
of the size of bfloat16 rounding alone) and the planted fault of half the
batch left out (the mean taken over the rest).  One process a cell; each
seed is a whole run of the cell's driver at ``--seconds``.

    python portbench/calibrate.py --workload granite-batch --seeds 1000-1011 --control 3 --seconds 8

One JSON line a reading, with ``correct``: the verdict of the cell's
limits file on it (the program's has to read true, the control's and each
fault's false); then one line with, for each number, the largest program
reading and the smallest of the control's, the witness's and each
fault's, and the verdicts."""

from __future__ import annotations

import argparse
import json
import sys
import time

T_START = time.perf_counter()

import run as harness  # noqa: E402  (portbench/run.py, beside this file)


def seeds(spec: str) -> list[int]:
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def half_batch():
    """Plant the fault: each step's loss over the first half of its rows."""
    import repro_torch.train.step as step_mod
    whole = step_mod._loss_fn

    def half(model, cfg, params, batch):
        h = batch["tokens"].shape[0] // 2
        return whole(model, cfg, params, {k: v[:h] for k, v in batch.items()})
    step_mod._loss_fn = half
    return lambda: setattr(step_mod, "_loss_fn", whole)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args()
    harness._paths()
    from portbench.drivers import train
    from portbench.lib import cell, device
    from portbench.lib import model as M
    from portbench.reference import dense as ref_dense
    work, conf, traffic, limits = cell.load_cell(args.workload)
    dev = device.require(work["chips"])
    drv = cell.driver(traffic["kind"])
    out: dict[str, dict] = {}
    verdicts: dict[str, list] = {}

    def note(kind, seed, numbers):
        ok = cell.passes(cell.checks(numbers, limits))
        print(json.dumps({"kind": kind, "seed": seed, "correct": ok,
                          **numbers}), flush=True)
        verdicts.setdefault(kind, []).append(ok)
        for k, v in numbers.items():
            out.setdefault(kind, {}).setdefault(k, []).append(v)

    for i, seed in enumerate(seeds(args.seeds)):
        ctx = cell.Context(cell=args.workload, conf=conf, traffic=traffic,
                           limits=limits, dims=M.dims(conf), seed=seed,
                           seconds=args.seconds, trace=False, device=dev,
                           t_start=time.perf_counter())
        if traffic["kind"] == "train":
            got = train.program(ctx)
            kinds = ["program"]
            if i < args.control:
                kinds += ["control", "witness_bf16"]
            precs = [None, ref_dense.FP8, ref_dense.BF16][:len(kinds)]
            for kind, numbers in zip(kinds, train.all_readings(ctx, got,
                                                               precs)):
                note(kind, seed, numbers)
            del got
            cell.free_device(dev)
            if i < args.control:
                undo = half_batch()
                try:
                    bad = train.program(ctx)
                finally:
                    undo()
                note("half_batch", seed, train.all_readings(ctx, bad)[0])
                del bad
        else:
            res = drv.run(ctx)
            note("program", seed, {k: v for k, v in
                                   res.layer["notes"]["readings"].items()})
            if i < args.control:
                note("control", seed, cell.compare_served(
                    ctx, res.layer["compare"], True))
            res.layer.clear()
        cell.free_device(dev)
    summary = {"program_max": {k: max(v) for k, v in out["program"].items()}}
    for kind in out:
        if kind != "program":
            summary[f"{kind}_min"] = {k: min(v) for k, v in out[kind].items()}
    summary["correct"] = verdicts
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
