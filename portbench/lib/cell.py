"""What one run of one cell holds, and the steps every driver shares:
building the program's model from the benchmark's weights, freeing it
before the reference runs, and the comparison of served tokens."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import time

import numpy as np
import torch

from . import device as dev
from . import model as M
from . import profile
from .model import ROOT
from ..reference import dense as ref_dense


@dataclasses.dataclass
class Context:
    """One run: the cell's files, the run's arguments, the device."""
    cell: str
    conf: dict                   # configs/<config>.json
    traffic: dict                # traffic/<traffic>.json
    limits: dict                 # limits/<cell>.json: {number: limit}
    dims: M.Dims
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float               # the process's start, perf_counter
    port_cfg: object = None      # the program's ModelConfig (tests set it)
    setup_s: float | None = None
    tracer: profile.Trace | None = None

    clocks: list = dataclasses.field(default_factory=list)

    def window_opens(self) -> float:
        """Set-up ends: what it made is moved out of the collector's way
        (``gc.freeze``), the card's clocks are read, and the window's
        clock starts."""
        gc.collect()
        gc.freeze()
        if self.device.type == "cuda":
            self.clocks.append(dev.clocks())
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        return now

    def window_closed(self) -> None:
        gc.unfreeze()
        if self.device.type == "cuda":
            self.clocks.append(dev.clocks())


@dataclasses.dataclass
class Result:
    metrics: dict                # end-to-end: name -> value
    attempted: int
    failed: int
    checks: dict                 # number -> (value, limit)
    peak_bytes: int
    layer: dict = dataclasses.field(default_factory=dict)  # readers' input

    @property
    def correct(self) -> bool:
        return passes(self.checks)


def load_cell(cell: str) -> tuple[dict, dict, dict, dict]:
    """(workload entry, config, traffic, limits) of ``cell`` from
    ``BENCHMARK.json`` and the files named after it."""
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise SystemExit(f"unknown workload {cell!r}; known: "
                         f"{sorted(work)}")
    w = work[cell]
    traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((ROOT / "limits" / f"{cell}.json").read_text())
    return w, M.load_config(w["config"]), traffic, limits


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def port_config(ctx: Context):
    """The program's configuration of the cell's model, held to the
    configuration file's sizes: a program whose widths moved is refused
    before anything runs."""
    if ctx.port_cfg is not None:
        return ctx.port_cfg
    from repro_torch.configs import get_config
    cfg = get_config(ctx.conf["port_config"])
    d = ctx.dims
    want = {"n_layers": d.L, "d_model": d.D, "n_heads": d.Hq,
            "n_kv_heads": d.Hkv, "hd": d.hd, "vocab": d.V,
            "tie_embeddings": d.tied, "qkv_bias": d.qkv_bias,
            "rope_theta": d.theta, "n_experts": d.E, "top_k": d.k,
            "compute_dtype": ctx.conf["torch_dtype"]}
    if d.family == "moe":
        want.update(d_expert=d.Fe, capacity_factor=d.capacity_factor,
                    moe_every=1)
    else:
        want["d_ff"] = d.F
    bad = {k: (getattr(cfg, k), v) for k, v in want.items()
           if getattr(cfg, k) != v}
    if bad or cfg.family != d.family:
        raise SystemExit(f"the program's {cfg.name} differs from "
                         f"configs/{ctx.conf['name']}.json: {bad}")
    return cfg


def build_program(ctx: Context):
    """(model, params): the program's model with the seed's weights, in
    the dtypes it serves them in (``params_from_numpy`` casts)."""
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy
    cfg = port_config(ctx)
    tree = M.make_weights(ctx.dims, ctx.seed, ctx.device)
    params = params_from_numpy(cfg, tree, device=ctx.device)
    del tree
    return get_model(cfg), params


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reference(family: str):
    return importlib.import_module(f"portbench.reference.{family}")


def served_gaps(d: M.Dims, tree: dict, samples, device,
                control: bool = False) -> dict:
    """For each ``(prompt, served)`` pair, the gap by which each served
    token's reference logit lies below the reference's best at its
    position; with ``control``, that of the token the FP8 reference puts
    first instead.  Returns the widest gap (``logit_gap``), the mean gap
    over the tokens (``logit_gap_mean``) and the tokens compared."""
    ref = reference(d.family)
    gaps = []
    with torch.no_grad():
        for prompt, served in samples:
            p = torch.as_tensor(np.asarray(prompt), device=device)
            s = torch.as_tensor(np.asarray(served), device=device)
            lg = ref.served_logits(d, tree, p, s)
            if control:
                s = ref.served_logits(d, tree, p, s,
                                      ref_dense.FP8).argmax(-1)
            gaps.append(lg.max(-1).values - lg.gather(1, s[:, None])[:, 0])
    g = torch.cat(gaps) if gaps else torch.zeros(0)
    return {"logit_gap": float(g.max()) if len(g) else None,
            "logit_gap_mean": float(g.mean()) if len(g) else None,
            "tokens": len(g)}


def compare_served(ctx: Context, compare, control: bool = False) -> dict:
    """Free the program, make the seed's weights again, and hold the
    served tokens ``compare`` to the reference (``served_gaps``)."""
    free_device(ctx.device)
    ref_dense.float32_only()
    tree = M.make_weights(ctx.dims, ctx.seed, ctx.device)
    out = served_gaps(ctx.dims, tree, compare, ctx.device, control)
    del tree
    free_device(ctx.device)
    return out


def checks(readings: dict, limits: dict) -> dict:
    """The numbers compared: each that the cell's limits file names, with
    its limit.  The other readings go to the result's notes only."""
    return {n: (readings.get(n), lim) for n, lim in limits.items()}


def passes(checks: dict) -> bool:
    """Whether every number compared is at or under its limit: what
    ``correct`` says of a run."""
    return all(v is not None and v <= lim for v, lim in checks.values())


def check_lines(checks: dict) -> dict:
    return {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
