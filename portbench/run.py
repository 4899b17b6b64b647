"""One run of one cell of the port's benchmark.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``), whose ``kind`` names the driver
(``portbench/drivers/<kind>.py``); its limits are
``portbench/limits/<cell>.json``.  The driver builds the program
(``repro_torch``, from ``src/``) with weights drawn from ``--seed``, warms
it up, measures for ``--seconds``, and compares what the timed path
produced with the plain reference (``portbench/reference/``).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` profiles a
slice of the window and prints its per-layer metrics, each read by
``portbench/metrics/<metric>.py``.  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that object.  Without a card,
or with fewer than the cell asks for, the run exits with no result."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    # the folders under portbench/ are no top-level packages
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != HERE]
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # any compiler cache a library opens stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(REPO / "build" / "inductor"))
    os.environ.setdefault("USE_FLAX", "0")
    # one host thread: the engine's host work is serial, and idle worker
    # threads on a shared host only add to the spread between runs
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def _reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def per_layer(bench: dict, cell: str, result) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if cell in m.get("workloads", [cell]):
            v = _reader(m["name"])(result.layer)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def end_to_end(bench: dict, cell: str, result, setup_s: float) -> dict:
    out = {}
    values = dict(result.metrics, setup_s=setup_s)
    for m in bench["end_to_end"]:
        if cell in m.get("workloads", [cell]):
            if values.get(m["name"]) is None:
                raise SystemExit(f"{cell}: no value for {m['name']}")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()

    from portbench.lib import cell, device
    from portbench.lib import model as M
    work, conf, traffic, limits = cell.load_cell(args.workload)
    dev = device.require(work["chips"])
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    ctx = cell.Context(cell=args.workload, conf=conf, traffic=traffic,
                       limits=limits, dims=M.dims(conf), seed=args.seed,
                       seconds=args.seconds, trace=bool(args.trace),
                       device=dev, t_start=T_START)
    result = cell.driver(traffic["kind"]).run(ctx)

    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed}
    if args.trace:
        line["metrics"] = per_layer(bench, args.workload, result)
    else:
        line["metrics"] = end_to_end(bench, args.workload, result,
                                     ctx.setup_s)
    line["device"] = device.info(dev, work["chips"], result.peak_bytes)
    tr = ctx.tracer
    if tr is not None and tr.hi > tr.lo:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        order = ("admit", "chunk", "step", "train", "feed", "snapshot")
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps(order)}
    line["notes"] = dict(result.layer.get("notes", {}), clocks=ctx.clocks)
    line["checks"] = cell.check_lines(result.checks)

    bad = loaded_forbidden()
    if bad:
        print(f"modules loaded that the port must not load: {bad}",
              file=sys.stderr)
        return 3
    for name, (v, lim) in result.checks.items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
