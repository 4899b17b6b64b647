"""Rank bodies of the port's sharded dense layers (``tests/test_torch_tp.py``),
run by ``repro_torch.distributed.ranks.run_ranks`` over gloo.  Spawned
ranks import this module afresh, so it imports neither JAX nor the JAX
package; bodies take and return numpy arrays and plain Python values."""

import dataclasses
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.audit import audited_call
from repro_torch.configs import get_config
from repro_torch.distributed import tp
from repro_torch.distributed.cost import CostCounter
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert, get_model
from repro_torch.models import moe as TM
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init
from repro_torch.train import make_train_step
from repro_torch.train.step import local_train_state, train_state_specs
from repro_torch.tree import tree_map


def _t(a):
    return torch.from_numpy(np.array(a))


def decode_cache(model, cache: dict, B: int, S: int, Smax: int) -> dict:
    """The rank's block of the (B, Smax) decode cache holding the prefill's
    rows: each leaf of the prefill cache gathered whole, padded to
    ``Smax`` along the axis that grows with position, and cut to the
    decode cache's block (``cache_logical_axes``)."""
    axes, seq = model.cache_logical_axes(), model.cache_seq_axes()
    shapes = {n: shape for n, (shape, _) in model.cache_spec(B, S).items()}
    out = {}
    for name, c in cache.items():
        whole = tp.full(c, axes[name], shapes[name])
        d = seq[name]
        if d is not None and whole.shape[d] < Smax:
            pad = list(whole.shape)
            pad[d] = Smax - whole.shape[d]
            whole = torch.cat([whole, whole.new_zeros(pad)], d)
        out[name] = tp.local_block(whole, axes[name]).contiguous()
    return out


def _decode(model, params, tokens, lens, dc, new, label) -> dict:
    """``new`` greedy tokens from each slot's position in ``lens`` (the
    prompt token there fed first) under the analysis audit's recorder: the
    stream, the findings (no host read, no float64, the cache written in
    place) and whether the cache kept its data_ptrs."""
    B, S = tokens.shape
    ptrs = {n: t.data_ptr() for n, t in dc.items()}
    tok = _t(tokens[np.arange(B), np.minimum(lens, S - 1)][:, None])
    pos = _t(np.asarray(lens, np.int32))
    (toks, _, _, dc), findings = audited_call(
        lambda: model.decode_fused(params, tok.long(), pos, dc, new),
        dc, f"{label} decode_fused under rules")
    return {"stream": toks.numpy(),
            "decode_findings": [f.message for f in findings],
            "ptrs_kept": all(dc[n].data_ptr() == p for n, p in ptrs.items())}


def _by_axis(mesh, ops) -> dict:
    """``"kind@axis"`` -> count of the collectives ``ops``."""
    axis = {tuple(dist.get_process_group_ranks(mesh.get_group(a))): a
            for a in mesh.mesh_dim_names}
    out = {}
    for o in ops:
        key = f"{o.kind}@{axis.get(o.ranks, '?')}"
        out[key] = out.get(key, 0) + 1
    return out


def _case(arch, mesh, tree, tokens, lens, Smax, new, train, opt):
    cfg = get_config(arch, reduced=True)
    model = get_model(cfg)
    out = {}
    B, S = tokens.shape
    with use_rules(mesh) as rules:
        params = convert.params_from_numpy(cfg, convert.local_tree(cfg, tree),
                                           "cpu")
        batch = {"tokens": _t(tokens).long()}
        with torch.no_grad():
            logits, cache = model.prefill(params, batch)
            out["prefill"] = logits.numpy()
            dc = decode_cache(model, cache, B, S, Smax)
            out.update(_decode(model, params, tokens, lens, dc, new, arch))
            with CostCounter() as c:
                model.forward(params, {"tokens": _t(train["tokens"]).long()})
            out["forward_coll"] = _by_axis(mesh, c.ops)
        state = {"params": tree_map(lambda a: _t(a).float(), tree)}
        state["opt"] = adamw_init(state["params"])
        state = local_train_state(model, state)
        step = make_train_step(model, AdamWConfig(**opt))
        new_state, metrics = step(state, {k: _t(v).long()
                                          for k, v in train.items()})
        out["loss"] = float(metrics["loss"])
        out["grad_norm"] = float(metrics["grad_norm"])
        out["params"] = tree_map(
            lambda names, s, t: tp.full(t, names, s).detach().numpy(),
            train_state_specs(model)["params"], convert.param_shapes(cfg),
            new_state["params"])
        out["fallbacks"] = sorted(set(rules.fallbacks))
    return out


def _serve_case(mesh, arch, over, mode, tree, batch, lens, Smax, new):
    """One model of another family, its configuration changed by
    ``over``, on the mesh: with ``mode`` "forward" the rank's logits and
    the global (row * S + position) index of each of them; else the
    prefill's logits and, with "decode", the decode stream as
    :func:`_case` runs it.  Also the layers computed whole on every rank
    of ``model`` and the ``all_to_all_single`` calls of the MoE blocks."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    model = get_model(cfg)
    out = {}
    with use_rules(mesh) as rules, torch.no_grad():
        params = convert.params_from_numpy(cfg, convert.local_tree(cfg, tree),
                                           "cpu")
        tb = {k: _t(v).long() if v.dtype.kind == "i" else _t(v)
              for k, v in batch.items()}
        a2a = TM.a2a_calls
        if mode == "forward":
            out["forward"] = model.forward(params, tb).numpy()
            B, S = batch["frames"].shape[:2]
            out["index"] = tp.token_block(
                torch.arange(B * S).reshape(B, S)).numpy()
        else:
            logits, cache = model.prefill(params, tb)
            out["prefill"] = logits.numpy()
        out["a2a"] = TM.a2a_calls - a2a
        if mode == "decode":
            B, S = batch["tokens"].shape
            dc = decode_cache(model, cache, B, S, Smax)
            out.update(_decode(model, params, batch["tokens"], lens, dc, new,
                               arch))
        out["replicated"] = sorted(rules.cache.get("replicated", ()))
    return out


def sharded_body(shape, cases, serve, Smax, new, opt):
    """On a (data, model) mesh of ``shape``, for each case (arch, the
    reference's parameter tree, prompts (B, S), per-slot start positions
    ``lens``, a train batch): the prefill's logits; the greedy stream of
    ``new`` tokens from decode steps starting at ``lens`` (the prompt
    token there fed first) over the prefill's cache in a ``Smax`` cache,
    and whether the cache kept its data_ptrs; the collectives of one
    training forward by kind and mesh axis; one AdamW step's loss,
    gradient norm and every updated parameter gathered whole; the rules'
    fallbacks.  Then each of ``serve`` (label -> (arch, config overrides,
    mode, parameter tree, batch, lens)) through :func:`_serve_case`."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    out = {arch: _case(arch, mesh, tree, tokens, lens, Smax, new, train,
                       opt)
           for arch, tree, tokens, lens, train in cases}
    for label, (arch, over, mode, tree, batch, lens) in serve.items():
        out[label] = _serve_case(mesh, arch, over, mode, tree, batch, lens,
                                 Smax, new)
    out["launcher"] = train_launcher.run(LAUNCH_ARGS, mesh)["losses"]
    out["thread_backward"] = _thread_backward(mesh, cases[0])
    return out


def _thread_backward(mesh, case):
    """The gradient of a training forward under rules, its backward run
    on another thread outside them (autograd's device thread on the card):
    the recomputed blocks take the forward's rules.  Returns the
    embedding's gradient."""
    arch, tree = case[0], case[1]
    cfg = get_config(arch, reduced=True)
    model = get_model(cfg)
    with use_rules(mesh):
        params = convert.params_from_numpy(cfg, convert.local_tree(cfg, tree),
                                           "cpu")
        for p in params.parameters():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = model.forward(params, {"tokens": _t(case[2]).long()}).sum()
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join()
    return params.tok.embed.grad.numpy()


# ``launch.train.run`` on the mesh: a few steps of reduced smollm
LAUNCH_ARGS = ["--device", "cpu", "--arch", "smollm-135m", "--reduced",
               "--steps", "3", "--seq-len", "16", "--lr", "5e-3",
               "--log-every", "100"]
