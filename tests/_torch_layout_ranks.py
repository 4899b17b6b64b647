"""Rank bodies of the serving cells under a ``tp`` layout
(``tests/test_torch_graph_layout.py``), run by
``repro_torch.distributed.ranks.run_ranks`` over gloo.  Spawned ranks
import this module afresh, so it imports neither JAX nor the JAX package;
bodies take and return numpy arrays and plain Python values."""

import contextlib
from unittest import mock

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import tp
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert, get_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import DonatedStep, make_train_step, train_state_init
from repro_torch.train.step import local_train_state
from repro_torch.tree import tree_items, tree_map

ARCH = "qwen2-0.5b"
B, T, SMAX, K = 2, 4, 32, 4
# per call, each slot's (start, live rows): slot 0 an 11-token prompt,
# slot 1 a 7-token one, padded in the second call and empty in the third
CALLS = (((0, 4), (0, 4)), ((4, 4), (4, 3)), ((8, 3), (7, 0)))


def _serve(model, params, fns, tokens, first) -> dict:
    """The chunks of ``tokens`` through ``fns["chunk"]`` (``CALLS``) into a
    zero cache (the rank's block of it under rules), then two fused decode
    chunks of ``K`` from each slot's prompt end, then two decode steps:
    (the chunks' logits, the fused decode's tokens and the steps' logits;
    the cache, which the caller keeps alive with its cells)."""
    axes = model.cache_logical_axes()
    cache = {n: torch.zeros(tp.local_shape(axes[n], s), dtype=dt)
             for n, (s, dt) in model.cache_spec(B, SMAX).items()}
    logits = []
    for tok, call in zip(tokens, CALLS):
        start = torch.tensor([s for s, _ in call], dtype=torch.int32)
        qlen = torch.tensor([n for _, n in call], dtype=torch.int32)
        out, cache = fns["chunk"](params, torch.from_numpy(tok).long(),
                                  cache, start, qlen)
        logits.append(out.numpy())
    tok = torch.from_numpy(first).long()[:, None]
    pos = torch.tensor([11, 7], dtype=torch.int32)
    toks = []
    for _ in range(2):
        out, tok, pos, cache = fns["fused"](params, tok, pos, cache, K)
        toks.append(out.numpy())
    steps = []
    for _ in range(2):
        out, cache = fns["step"](params, tok, pos, cache)
        steps.append(out.numpy())
        tok = out[:, -1].argmax(-1)[:, None]
        pos = pos + 1
    return {"chunk": np.stack(logits), "fused": np.concatenate(toks, 1),
            "step": np.stack(steps)}, cache


def _entries(model) -> dict:
    return {"chunk": model.prefill_chunk, "fused": model.decode_fused,
            "step": model.decode_step}


def _built(model) -> dict:
    return {n: f.cells() for n, f in _entries(model).items()}


def _since(model, before: dict) -> dict:
    return {n: c - before[n] for n, c in _built(model).items()}


def _model(seed: int):
    cfg = get_config(ARCH, reduced=True)
    model = get_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(seed)
    full = model.init(gen, "cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (len(CALLS), B, T))
    first = rng.integers(0, cfg.vocab, B)
    return cfg, model, full, tokens, first


def sharded_body(seed: int) -> dict:
    """Two ranks, a (data 1, model 2) mesh, qwen2 reduced on each rank's
    blocks: the cells under the gloo layout (none built, the eager bodies
    run), then with ``Layout.capturable`` patched true (cells built under
    the layout, keyed by it); each against the eager bodies under
    rules."""
    cfg, model, full, tokens, first = _model(seed)
    tree = convert.param_tree(cfg, full)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    eager = {n: f.eager for n, f in _entries(model).items()}
    out = {}
    with torch.no_grad():
        with use_rules(mesh):
            local = convert.params_from_numpy(
                cfg, convert.local_tree(cfg, tree), "cpu")
            out["capturable"] = tp.layout().capturable
            out["want"] = _serve(model, local, eager, tokens, first)[0]
            before = _built(model)
            out["gloo"] = _serve(model, local, _entries(model), tokens,
                                 first)[0]
            out["built_gloo"] = _since(model, before)
        with mock.patch.object(tp.Layout, "capturable", True), \
                use_rules(mesh):
            ident = tp.layout().ident
            before = _built(model)
            out["patched"], cache = _serve(model, local, _entries(model),
                                           tokens, first)
            out["built_patched"] = _since(model, before)
            out["keyed_by_layout"] = all(
                key[-1] == ident for f in _entries(model).values()
                for key in f._cells)
    return out


def one_rank_body(seed: int) -> dict:
    """One rank, a (data 1, model 1) mesh, so the cache and the params
    have the same shapes with and without rules; ``Layout.capturable``
    patched true: the same cache and params build one cell of each entry
    without rules and another under them, and each call after finds its
    own."""
    cfg, model, full, tokens, first = _model(seed)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cache = {n: torch.zeros(s, dtype=dt)
             for n, (s, dt) in model.cache_spec(B, SMAX).items()}
    tok = torch.from_numpy(first).long()[:, None]
    pos = torch.tensor([3, 5], dtype=torch.int32)
    out = {"built": []}
    with torch.no_grad(), mock.patch.object(tp.Layout, "capturable", True):
        for ruled in (False, True, False, True):
            before = _built(model)
            with use_rules(mesh) if ruled else contextlib.nullcontext():
                model.prefill_chunk(full, torch.from_numpy(tokens[0]).long(),
                                    cache, torch.zeros(B, dtype=torch.int32),
                                    torch.full((B,), T, dtype=torch.int32))
                model.decode_fused(full, tok, pos, cache, K)
                model.decode_step(full, tok, pos, cache)
            out["built"].append(_since(model, before))
    out["live"] = {n: f.live() for n, f in _entries(model).items()}
    return out


def train_body(seed: int) -> dict:
    """Two ranks, a (data 1, model 2) mesh, qwen2 reduced, two microbatches
    and ``compress_dcn``: two donated train steps on each rank's blocks
    of the state under the gloo layout (no cell built: the eager body in
    place), then with ``Layout.capturable`` patched true (one cell, keyed
    by the layout); each against two steps of the functional
    ``TrainStep`` under rules, bit for bit."""
    cfg, model, _, tokens, _ = _model(seed)
    opt = AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=10)
    gen = torch.Generator()
    gen.manual_seed(seed)
    s0 = train_state_init(model, gen, opt, compress_dcn=True, device="cpu")
    toks = torch.from_numpy(tokens[:2].reshape(-1, 2 * T)).long()
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}
    kw = dict(microbatches=2, compress_dcn=True)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")

    def steps(step, ruled):
        with use_rules(mesh):
            state = tree_map(lambda t: t.clone(), local_train_state(model,
                                                                    s0))
            for _ in range(2):
                got, m = step(state, batch)
                assert ruled or got is state
                state = got
        return state, float(m["loss"])

    def equal(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(tree_items(a), tree_items(b)))

    want, loss = steps(make_train_step(model, opt, **kw), True)
    gloo = DonatedStep(make_train_step(model, opt, **kw))
    got, gloo_loss = steps(gloo, False)
    out = {"capturable": None, "loss": loss, "built_gloo": gloo.cell.cells(),
           "equal_gloo": equal(got, want) and gloo_loss == loss}
    with use_rules(mesh):
        out["capturable"] = tp.layout().capturable
    patched = DonatedStep(make_train_step(model, opt, **kw))
    with mock.patch.object(tp.Layout, "capturable", True):
        got, patched_loss = steps(patched, False)
        with use_rules(mesh):
            ident = tp.layout().ident
    out["built_patched"] = patched.cell.cells()
    out["keyed_by_layout"] = all(key[-1] == ident
                                 for key in patched.cell._cells)
    out["equal_patched"] = equal(got, want) and patched_loss == loss
    return out
