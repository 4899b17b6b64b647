"""Dry run of the port over the production meshes: the counterpart of
``repro/launch/dryrun.py``.  Every (architecture x input shape x mesh)
cell's program is traced as rank 0 of the mesh's world (256 ranks single
pod, 512 multi-pod) under ``FakeTensorMode`` and PyTorch's fake process
group: no device, no memory, no JAX.  The cost counter
(``distributed/cost.py``) prices what the rank runs: FLOPs, bytes,
collectives, peak memory, each hand-written kernel's calls; the roofline
(``distributed/roofline.py``, H100 constants) reads them.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both

One JSON artifact per cell in ``--out`` (default
``artifacts/dryrun_torch``), in the reference's record layout (status
``ok``, ``skipped`` with the reference's reason, or ``failed`` with the
error), plus ``replicated_layers``: what computed whole on every rank of
``model`` under the rules.  ``RooflineLatencyModel.from_artifact``
(``distributed/elastic.py``) reads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, SHAPES, get_config, input_specs
from ..configs import shape_skip_reason
from ..distributed import roofline, tp
from ..distributed.cost import CostCounter
from ..distributed.sharding import use_rules
from ..models import convert, get_model
from ..optim.adamw import AdamWConfig
from ..train.step import local_train_state, make_train_step, train_state_init
from .mesh import devices_per_pod, make_mesh

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def fake_world(world: int) -> None:
    """This process as rank 0 of a ``world``-rank fake process group (a
    group already there is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake(spec: torch.Tensor) -> torch.Tensor:
    """A zero tensor of ``spec``'s shape and dtype (fake under the mode)."""
    return torch.zeros(spec.shape, dtype=spec.dtype)


def trace(cfg, kind: str, batch: dict, mesh, dpp: int | None = None,
          opt: AdamWConfig | None = None, rules_overrides=None,
          seq: int = 0, microbatches: int = 1):
    """Trace one step of ``cfg`` on fake tensors as this rank of ``mesh``
    (a ``DeviceMesh`` over a fake or real group): ``kind`` ``train`` (one
    AdamW step over ``microbatches`` parts of the batch), ``prefill`` or
    ``decode`` (one token against a cache of ``seq`` rows); ``batch``
    holds the global inputs' stand-ins (``configs.input_specs``).  Returns
    (counter, rules)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    convert.param_shapes(cfg)                  # built before the counter
    model = get_model(cfg)
    with FakeTensorMode(), use_rules(mesh, rules_overrides) as rules:
        gen = torch.Generator()
        counter = CostCounter(dpp)
        if kind == "train":
            opt = opt or AdamWConfig()
            state = local_train_state(model, train_state_init(
                model, gen, opt, device="cpu"))
            step = make_train_step(model, opt, microbatches=microbatches)
            step._compute.load(state["params"])       # the compute copy
            inputs = {k: _fake(v) for k, v in batch.items()}
            counter.track((state, inputs, list(step.module.parameters())))
            with counter:
                step(state, inputs)
            return counter, rules
        full = model.init(gen, "cpu")
        params = convert.params_from_numpy(
            cfg, convert.local_tree(cfg, convert.param_tree(cfg, full)),
            "cpu")
        del full
        counter.track(list(params.parameters()))
        with torch.no_grad():
            if kind == "prefill":
                inputs = {k: _fake(v) for k, v in batch.items()}
                counter.track(inputs)
                with counter:
                    model.prefill(params, inputs)
                return counter, rules
            token = _fake(batch["token"])
            B, S = token.shape[0], seq
            axes = model.cache_logical_axes()
            cache = {n: torch.zeros(tp.local_shape(axes[n], shape),
                                    dtype=dt)
                     for n, (shape, dt) in model.cache_spec(B, S).items()}
            pos = torch.full((B,), S - 1, dtype=torch.int32)
            counter.track((token, cache, pos))
            with counter:
                model.decode(params, token.long(), pos, cache)
    return counter, rules


def run_cell(arch: str, shape: str, mesh_kind: str,
             cfg_overrides: dict | None = None,
             rules_overrides: dict | None = None,
             microbatches: int = 1) -> dict:
    """One cell's record (the reference's ``run_cell``; ``microbatches``
    splits a train step's batch, as the reference's does)."""
    cfg = get_config(arch)
    skip = shape_skip_reason(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "skipped", "reason": skip}
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    kind = SHAPES[shape]["kind"]
    if kind != "train":                      # the reference serves in bf16
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    dims, axes = MESHES[mesh_kind]
    chips = math.prod(dims)
    fake_world(chips)
    t0 = time.perf_counter()
    try:
        dev_mesh = make_mesh(dims, axes, "cpu")
        dpp = devices_per_pod(dev_mesh)
        counter, rules = trace(cfg, kind, input_specs(cfg, shape), dev_mesh,
                               dpp, rules_overrides=rules_overrides,
                               seq=SHAPES[shape]["seq_len"],
                               microbatches=microbatches)
    finally:
        dist.destroy_process_group()
    t_trace = time.perf_counter() - t0
    totals = counter.totals
    rf = roofline.build_from_walker(arch, shape, mesh_kind, chips, totals,
                                    cfg, peak_mem_bytes=counter.peak_bytes)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "ok",
        "chips": chips, "kind": kind, "trace_s": round(t_trace, 1),
        "memory": {"peak_bytes": int(counter.peak_bytes)},
        "collectives": {
            "counts": {k: float(v) for k, v in totals.coll_counts.items()},
            "operand_bytes": totals.coll_operand,
            "wire_ici": totals.wire_ici,
            "wire_dcn": totals.wire_dcn,
        },
        "roofline": rf.to_dict(),
        "tags": {"bytes": dict(totals.tag_bytes),
                 "flops": dict(totals.tag_flops),
                 "calls": dict(counter.calls)},
        "sharding_fallbacks": list(rules.fallbacks),
        "replicated_layers": sorted(rules.cache.get("replicated", ())),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for a, s, mk in cells:
        path = os.path.join(args.out, f"{a}__{s}__{mk}.json")
        if args.skip_existing and os.path.exists(path):
            print(f"== {a} x {s} x {mk}: exists, skipping")
            continue
        print(f"== {a} x {s} x {mk} ==", flush=True)
        t0 = time.perf_counter()
        try:
            rec = run_cell(a, s, mk)
        except Exception as e:       # recorded as a fault to fix
            traceback.print_exc()
            rec = {"arch": a, "shape": s, "mesh": mk, "status": "failed",
                   "error": f"{type(e).__name__}: {e}"}
        rec["wall_s"] = round(time.perf_counter() - t0, 2)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_fail += st == "failed"
        if st == "ok":
            r = rec["roofline"]
            print(f"   ok: dominant={r['dominant']} "
                  f"fraction={r['roofline_fraction']:.3f} "
                  f"mem/dev={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                  f"({rec['wall_s']} s)", flush=True)
        else:
            print(f"   {st}: {rec.get('reason', rec.get('error'))}",
                  flush=True)
    print(f"dry-run complete: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
