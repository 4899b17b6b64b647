"""``train``: a training job on the launcher's path
(``repro_torch.launch.train`` -> ``train.step.DonatedStep``: one CUDA graph
a batch shape and state, the state updated in place), steps back to back.

Set-up builds the one training state (float32 masters from the seed's
weights, AdamW's zeros) and the one ``DonatedStep``, and drives them
through their first three steps, the first of which builds the cell; the
window then goes on with the same objects.  Every step's tokens are drawn
on the card from the seed, so no two rows repeat.  In the window the host
reads a step's loss after it has launched the next, so the card never
waits on the host and the host never runs more than a step ahead.  Before
the window's step ``compare_at`` (the traffic file's) and after the three
steps from it, the whole state (parameters, both moments, the step
counter) is copied aside on the card; the window runs on to its end.  The
steps compared are thus the same for every window that reaches them, and
past the learning rate's warm-up.

End-to-end: ``train_tok_s``, the tokens of every step launched in the
window over the time from its opening to the sync that ends its last step.

Two comparisons with the reference (``reference/train.py``), in float32:

- the start: the reference runs set-up's three steps from the seed's
  weights on the same tokens.  Held to it: each step's global gradient
  norm before clipping, the step-1 gradient as AdamW took it (the
  program's read back from its first moment, ``m / (1 - b1)``) and the
  change of the parameters over the three steps.
- in the window: the reference runs the three steps from ``compare_at``
  on their tokens from the state copied before them, the program's own
  (the reference cannot follow a hundred steps itself), at the step
  number the harness counted.  Held to it: each step's gradient norm, the
  gradients AdamW took, read back from each moment's change over the
  three steps (``(m3 - b1^3 m0) / (1 - b1)`` and ``(v3 - b2^3 v0) /
  (1 - b2)``), the parameters' change, and the program's step counter.

A leaf is judged by its worst case: a gap between two norms, or the norm
of a difference, over the larger of the reference's norm of that leaf and
of the median leaf.  Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone and are left out of the
change."""

from __future__ import annotations

import time

import torch

from ..lib import cell, stats
from ..lib import device as dev
from ..lib import model as M
from ..lib import profile
from ..reference import dense as ref_dense
from ..reference import train as ref_train

SETUP_STEPS = 3
END_STEPS = 3


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between two norms over the larger of its
    reference norm and the median leaf's."""
    med = stats.median(list(ref.values()))
    return max(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
               for p in ref if keep is None or p in keep)


def leaf_diff(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's norm of the difference of two tensors over the
    larger of its reference norm and the median leaf's."""
    norms = {p: float(t.norm()) for p, t in ref.items()}
    med = stats.median(list(norms.values()))
    return max(float((prog[p] - t).norm()) / max(norms[p], med, 1e-30)
               for p, t in ref.items() if keep is None or p in keep)


def _empty_like(tree: dict) -> dict:
    return {k: _empty_like(v) if isinstance(v, dict) else torch.empty_like(v)
            for k, v in tree.items()}


def _copy_into(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def _moment_sums(hp: dict, m0: dict, v0: dict, m3: dict, v3: dict):
    """The gradients the moments took over three steps, read back from
    their change: ``b1^2 g1 + b1 g2 + g3`` and the same of the squares
    with ``b2``, by path."""
    b1, b2 = hp["b1"], hp["b2"]
    gm = {p: (m3[p] - b1 ** END_STEPS * m0[p]) / (1 - b1) for p in m3}
    gv = {p: (v3[p] - b2 ** END_STEPS * v0[p]) / (1 - b2) for p in v3}
    return gm, gv


def program(ctx: cell.Context) -> dict:
    """Set-up, its three steps and the window, on the program.  Returns
    the start's readings (losses, gradient norms, the step-1 gradient,
    the change's leaf norms) and tokens, the window's compared steps'
    (the state copied before them, their tokens, losses, gradient norms,
    the moments' sums and the parameters' change), and the window's
    numbers."""
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import DonatedStep, make_train_step
    tr, d = ctx.traffic, ctx.dims
    hp = tr["adamw"]
    B, S = int(tr["batch"]), int(tr["seq"])
    model = get_model(cell.port_config(ctx))
    params = M.make_weights(d, ctx.seed, ctx.device)
    state = {"params": params, "opt": adamw_init(params)}
    step = DonatedStep(make_train_step(model, AdamWConfig(**hp)))
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed) % 2**63)

    def feed() -> torch.Tensor:
        return torch.randint(0, d.V, (B, S + 1), generator=gen,
                             device=ctx.device)

    def batch(t: torch.Tensor) -> dict:
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    start = {p: t.clone() for p, t in ref_train.leaves(params)}
    first, losses, norms, grad1 = [], [], [], None
    for i in range(SETUP_STEPS):
        toks = feed()
        first.append(toks.cpu())
        state, m = step(state, batch(toks))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            grad1 = {p: (t / (1 - hp["b1"])).cpu()
                     for p, t in ref_train.leaves(state["opt"]["m"])}
    change = {p: float((t - start[p]).norm())
              for p, t in ref_train.leaves(params)}
    del start
    at = int(tr["compare_at"])
    snap, after = _empty_like(state), _empty_like(state)

    tracer = profile.Trace()
    ctx.tracer = tracer if ctx.trace else None
    if ctx.trace:
        tracer.warm()
    t0 = ctx.window_opens()
    t_end = t0 + ctx.seconds
    slice_lo = t_end - min(tr["trace_slice_s"], ctx.seconds)
    n, prev, tail = 0, None, []
    # a window too short for the compared steps runs on until they are done
    while time.perf_counter() < t_end or n < at + END_STEPS:
        if n in (at, at + END_STEPS):
            with tracer.phase("snapshot"):
                _copy_into(snap if n == at else after, state)
        if ctx.trace and not tracer.active and \
                time.perf_counter() >= slice_lo:
            tracer.start()
        with tracer.phase("feed"):
            toks = feed()
        with tracer.phase("train"):
            state, m = step(state, batch(toks))
            if tracer.active:
                float(m["loss"])          # a traced step ends in its sync
        if at <= n < at + END_STEPS:
            tail.append((toks, m))
        if prev is not None:
            float(prev["loss"])
        prev, n = m, n + 1
    last_loss = float(prev["loss"])
    t_close = time.perf_counter()
    ctx.window_closed()
    if tracer.active:
        tracer.stop()
    if n == at + END_STEPS:
        _copy_into(after, state)
    peak = dev.peak_bytes(ctx.device)
    del state

    gm, gv = _moment_sums(hp, dict(ref_train.leaves(snap["opt"]["m"])),
                          dict(ref_train.leaves(snap["opt"]["v"])),
                          dict(ref_train.leaves(after["opt"]["m"])),
                          dict(ref_train.leaves(after["opt"]["v"])))
    before = dict(ref_train.leaves(snap["params"]))
    end = {"snap": snap, "at": SETUP_STEPS + at,
           "toks": [t for t, _ in tail],
           "losses": [float(m["loss"]) for _, m in tail],
           "norms": [float(m["grad_norm"]) for _, m in tail],
           "steps": int(after["opt"]["step"]) - int(snap["opt"]["step"]),
           "counter": int(snap["opt"]["step"]),
           "gm": gm, "gv": gv,
           "dp": {p: t - before[p]
                  for p, t in ref_train.leaves(after["params"])}}
    del after
    return {"losses": losses, "norms": norms, "grad1": grad1,
            "change": change, "first": first, "end": end, "n": n, "t0": t0,
            "t_close": t_close, "peak": peak, "last_loss": last_loss}


def reference(ctx: cell.Context, first, prec=ref_dense.EXACT) -> dict:
    """The reference's three steps on the seed's weights and the tokens
    ``first``, in ``prec``: the same readings as :func:`program`'s
    start."""
    d, hp = ctx.dims, ctx.traffic["adamw"]
    cell.free_device(ctx.device)
    ref_dense.float32_only()
    tree = M.make_weights(d, ctx.seed, ctx.device)
    mom = {"m": {}, "v": {}}
    fam = cell.reference(d.family)
    losses, norms, grad1 = [], [], None
    for i, toks in enumerate(first):
        loss, g = ref_train.loss_and_grads(d, tree, toks.to(ctx.device), fam,
                                           prec=prec)
        norms.append(ref_train.global_norm(g))
        clipped = ref_train.adamw(hp, tree, g, mom, i + 1)
        losses.append(loss)
        if i == 0:
            grad1 = {p: t.cpu() for p, t in clipped.items()}
        del g, clipped
    start = dict(ref_train.leaves(M.make_weights(d, ctx.seed, ctx.device)))
    change = {p: float((t - start[p]).norm())
              for p, t in ref_train.leaves(tree)}
    del tree, start, mom
    cell.free_device(ctx.device)
    return {"losses": losses, "norms": norms, "grad1": grad1,
            "change": change}


def window_reference(ctx: cell.Context, end: dict,
                  prec=ref_dense.EXACT) -> dict:
    """The reference's three steps from the program's state copied before
    the window's compared three (``end["snap"]``, left as it is), on their
    tokens, at the steps the harness counted, in ``prec``: losses,
    gradient norms, the moments' sums and the parameters' change."""
    d, hp = ctx.dims, ctx.traffic["adamw"]
    cell.free_device(ctx.device)
    ref_dense.float32_only()
    snap = end["snap"]
    tree = _empty_like(snap["params"])
    _copy_into(tree, snap["params"])
    m0 = dict(ref_train.leaves(snap["opt"]["m"]))
    v0 = dict(ref_train.leaves(snap["opt"]["v"]))
    mom = {"m": {p: t.clone() for p, t in m0.items()},
           "v": {p: t.clone() for p, t in v0.items()}}
    fam = cell.reference(d.family)
    losses, norms = [], []
    for i, toks in enumerate(end["toks"]):
        loss, g = ref_train.loss_and_grads(d, tree, toks, fam, prec=prec)
        norms.append(ref_train.global_norm(g))
        ref_train.adamw(hp, tree, g, mom, end["at"] + i + 1)
        losses.append(loss)
        del g
    gm, gv = _moment_sums(hp, m0, v0, mom["m"], mom["v"])
    before = dict(ref_train.leaves(snap["params"]))
    dp = {p: t - before[p] for p, t in ref_train.leaves(tree)}
    del tree, mom
    cell.free_device(ctx.device)
    return {"losses": losses, "norms": norms, "gm": gm, "gv": gv, "dp": dp,
            "steps": END_STEPS, "counter": end["at"]}


def _rel(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def readings(got: dict, ref: dict) -> tuple[dict, list]:
    """Every number of the start that ``got`` (the program's three steps,
    or a control's) reads against ``ref`` (the reference's), and the
    leaves left out of the change (reference gradient under a thousandth
    of the median leaf's).  ``grad_norm_gap``: each step's global gradient
    norm before clipping (the program's ``grad_norm``), the widest
    relative gap; the clipped gradient AdamW takes hides a batch's size.
    ``grad_leaf_diff``: the step-1 gradient's worst leaf by the norm of the
    difference; the gaps between two norms average a leaf's rounding away,
    and no control reads them apart from the program (PERF.md)."""
    g_ref = {p: float(t.norm()) for p, t in ref["grad1"].items()}
    g_got = {p: float(t.norm()) for p, t in got["grad1"].items()}
    med = stats.median(list(g_ref.values()))
    moved = {p for p, g in g_ref.items() if g >= 1e-3 * med}
    return {
        "loss_gap": _rel(got["losses"], ref["losses"]),
        "grad_norm_gap": _rel(got["norms"], ref["norms"]),
        "grad_leaf_gap": leaf_gap(g_got, g_ref),
        "grad_leaf_diff": leaf_diff(got["grad1"], ref["grad1"]),
        "update_leaf_gap": leaf_gap(got["change"], ref["change"], moved),
    }, sorted(set(g_ref) - moved)


def window_readings(got: dict, ref: dict) -> tuple[dict, list]:
    """Every number of the window's compared steps that ``got`` (the
    program's, or a control's) reads against ``ref``, and the leaves left
    out of the change.  ``window_steps``: how far the program's step
    counter is off the harness's count, before and over the three
    steps."""
    g_ref = {p: float(t.norm()) for p, t in ref["gm"].items()}
    med = stats.median(list(g_ref.values()))
    moved = {p for p, g in g_ref.items() if g >= 1e-3 * med}
    norms = lambda tree: {p: float(t.norm()) for p, t in tree.items()}
    return {
        "window_loss_gap": _rel(got["losses"], ref["losses"]),
        "window_grad_norm_gap": _rel(got["norms"], ref["norms"]),
        "window_m_diff": leaf_diff(got["gm"], ref["gm"]),
        "window_v_diff": leaf_diff(got["gv"], ref["gv"]),
        "window_update_leaf_gap": leaf_gap(norms(got["dp"]), norms(ref["dp"]),
                                        moved),
        "window_update_diff": leaf_diff(got["dp"], ref["dp"], moved),
        "window_steps": abs(got["counter"] - ref["counter"])
        + abs(got["steps"] - ref["steps"]),
    }, sorted(set(g_ref) - moved)


def all_readings(ctx: cell.Context, got: dict, precs=(None,)) -> list:
    """The start's and the window's numbers, one dict for each of
    ``precs``: for None, of the program's run ``got``; for a precision, of
    the reference in it put in the program's place on the same tokens and
    the same state copied before the window's compared steps (a
    control)."""
    ref = reference(ctx, got["first"])
    win_ref = window_reference(ctx, got["end"])
    out = []
    for prec in precs:
        if prec is None:
            start, end = got, got["end"]
        else:
            start = reference(ctx, got["first"], prec)
            end = window_reference(ctx, got["end"], prec)
        out.append({**readings(start, ref)[0],
                    **window_readings(end, win_ref)[0]})
        del start, end
    return out


def run(ctx: cell.Context) -> cell.Result:
    tr = ctx.traffic
    got = program(ctx)
    read, left_out = readings(got, reference(ctx, got["first"]))
    win_ref = window_reference(ctx, got["end"])
    win_read, window_left_out = window_readings(got["end"], win_ref)
    del got["end"], win_ref
    cell.free_device(ctx.device)
    read.update(win_read)
    tokens = got["n"] * int(tr["batch"]) * int(tr["seq"])
    return cell.Result(
        metrics={"train_tok_s": tokens / (got["t_close"] - got["t0"])},
        attempted=got["n"], failed=0, checks=cell.checks(read, ctx.limits),
        peak_bytes=got["peak"],
        layer={"trace": ctx.tracer, "dims": ctx.dims, "traffic": tr,
               "t0": got["t0"], "t_close": got["t_close"],
               "steps": got["n"],
               "notes": {"readings": read, "losses": got["losses"],
                         "last_loss": got["last_loss"],
                         "left_out": left_out,
                         "window_left_out": window_left_out}})
