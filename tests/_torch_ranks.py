"""Rank bodies of the port's multi-rank CPU tests, run by
``repro_torch.distributed.ranks.run_ranks`` over gloo.  Spawned ranks
import the body's module afresh, so the bodies live here, in a module
that imports neither JAX nor the JAX package, and take and return numpy
arrays and plain Python values."""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed import elastic_remesh
from repro_torch.distributed.sharding import (NamedSharding, P, constrain,
                                              logical_sharding, use_rules)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_model
from repro_torch.models import moe as TM
from repro_torch.models.convert import (param_specs, train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import AdamWConfig, compressed_allreduce_demo
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves, tree_map


def _t(a):
    return torch.from_numpy(np.array(a))


def moe_ep_body(shape, cfg_kw, params, x, x_big):
    """``moe_ep`` on a (data, model) mesh of ``shape`` at each capacity
    factor of ``cfg_kw["capacity_factor"]`` (a list); then, at the first
    factor, ``moe_ffn``'s routing under rules, counted in
    ``all_to_all_single`` calls."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    out = {}
    for cf in cfg_kw["capacity_factor"][::-1]:
        cfg = ModelConfig(**dict(cfg_kw, capacity_factor=cf))
        p = TM.MoE(cfg, {k: _t(v) for k, v in params.items()})
        with use_rules(mesh):
            out[cf] = TM.moe_ep(cfg, p, _t(x)).numpy()
    counts = {}
    with use_rules(mesh):
        for label, xin, decode in (("prefill", x_big, False),
                                   ("decode", x_big, True),
                                   ("4096", x_big[:, :2048], False)):
            n0 = TM.a2a_calls
            y = TM.moe_ffn(cfg, p, _t(xin), decode)
            counts[label] = TM.a2a_calls - n0
            if label == "prefill":
                out["prefill"] = y.numpy()
    out["a2a"] = counts
    return out


def demo_body(x):
    """``compressed_allreduce_demo`` on (pod 2, data 4), with the dtypes
    that ``all_gather`` was given."""
    mesh = make_mesh((2, 4), ("pod", "data"), "cpu")
    gathered = []
    all_gather = dist.all_gather

    def spy(tensors, tensor, group=None, *a, **kw):
        gathered.append((tensor.dtype, dist.get_world_size(group)))
        return all_gather(tensors, tensor, group, *a, **kw)
    dist.all_gather = spy
    try:
        out = compressed_allreduce_demo(_t(x), mesh)
    finally:
        dist.all_gather = all_gather
    return out.numpy(), [(str(d), n) for d, n in gathered]


ELASTIC_ARCH = "smollm-135m"
ELASTIC_OPT = dict(lr=3e-3, warmup_steps=2, total_steps=12)
ELASTIC_DATA = dict(global_batch=8, seq_len=16, seed=5)


def elastic_steps(step, data, state, lo, hi):
    for i in range(lo, hi):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        state, _ = step(state, batch)
    return state


def _replicated(tree):
    return lambda mesh: tree_map(lambda _: NamedSharding(mesh, P()), tree)


def _local(tree):
    return tree_map(lambda d: d.to_local(), tree)


def _on(tree, mesh):
    return tree_map(lambda t: DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False), tree)


def elastic_train_body(state_np, steps):
    """The counterpart of ``tests/test_elastic.py``'s elastic restart:
    the state replicated over 8 ranks, ``steps`` steps, every rank taking
    part in the mesh of ranks 0-3 (creating one is collective), ranks 4-7
    gone, the state re-meshed onto 0-3 and ``steps`` more steps.  Rank 0
    returns the final parameters."""
    model = get_model(get_config(ELASTIC_ARCH, reduced=True))
    step = make_train_step(model, AdamWConfig(**ELASTIC_OPT))
    data = SyntheticLMData(DataConfig(vocab=model.cfg.vocab, **ELASTIC_DATA))
    try:
        mesh8 = make_mesh((8,), ("data",), "cpu")
        mesh4 = DeviceMesh("cpu", [0, 1, 2, 3], mesh_dim_names=("data",))
        state = train_state_from_numpy(state_np, "cpu")
        shardings = _replicated(state)
        state = elastic_remesh(state, shardings, mesh8)
        state = _on(elastic_steps(step, data, _local(state), 0, steps),
                    mesh8)
        if dist.get_rank() >= 4:                 # the lost half
            return None
        state = elastic_remesh(state, shardings, mesh4)   # survivors
        assert state["params"]["ln_f"]["scale"].device_mesh is mesh4
        state = elastic_steps(step, data, _local(state), steps, 2 * steps)
    finally:
        data.close()
    if dist.get_rank() == 0:
        return train_state_to_numpy(state["params"])
    return None


def logical_remesh_body(params_np):
    """A parameter tree placed by ``logical_sharding`` on (data 2, model
    4), re-meshed onto (data 1, model 4) over ranks 0-3 (every rank
    gathers; ranks 4-7 end with empty shards), then ``full_tensor()`` on
    the new mesh.  Also ``constrain`` on a DTensor under rules."""
    cfg = get_config(ELASTIC_ARCH, reduced=True)
    specs = param_specs(cfg)
    params = tree_map(_t, params_np)
    mesh_a = make_mesh((2, 4), ("data", "model"), "cpu")
    mesh_b = DeviceMesh("cpu", [[0, 1, 2, 3]],
                        mesh_dim_names=("data", "model"))

    def shardings(mesh):
        return tree_map(lambda names, t: logical_sharding(mesh, names,
                                                          t.shape),
                        specs, params)
    placed = elastic_remesh(params, shardings, mesh_a)
    out = {"placements_a": [str(d.placements)
                            for d in placed["tok"].values()]}
    moved = elastic_remesh(placed, shardings, mesh_b)
    if dist.get_rank() < 4:
        full = tree_map(lambda d: d.full_tensor(), moved)
        out["equal"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(full), tree_leaves(params)))
        out["placements_b"] = [str(d.placements) for d in
                               moved["tok"].values()]
    else:
        out["empty"] = all(d.to_local().numel() == 0
                           for d in tree_leaves(moved))
    # constrain: a replicated (8, 16) DTensor to ("batch", "ff")
    x = torch.arange(128.).reshape(8, 16)
    d = distribute_tensor(x, mesh_a, [Replicate(), Replicate()])
    with use_rules(mesh_a):
        c = constrain(d, "batch", "ff")
    out["constrain"] = (str(c.placements), tuple(c.to_local().shape),
                        bool(torch.equal(c.full_tensor(), x)))
    return out
