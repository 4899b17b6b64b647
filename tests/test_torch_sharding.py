"""The port's sharding rules (``repro_torch.distributed.sharding``) and
spec trees (``models.convert.param_specs``, ``train.train_state_specs``)
held against the JAX package's on the CPU, in process.

The reference's ``AxisRules`` reads only ``mesh.shape`` (a name -> size
mapping), so a ``SimpleNamespace(shape=...)`` stands in for its mesh and
a plain mapping for the port's: the spec arithmetic needs no device and
no process group.  Every case compares the spec entries and the recorded
fallback strings exactly.

* ``tests/test_sharding.py``'s cases (9 heads over ``model`` 4 fall back
  to replication, ``fsdp`` cannot reuse ``data``, a batch of 2 on
  ``(pod, data)`` falls back to ``pod``) and qwen2's 14 heads over 16;
* every leaf of every family's spec tree at full width on the production
  meshes' ``(16, 16)`` and ``(2, 16, 16)`` shapes;
* ``param_specs`` and ``train_state_specs`` equal to the reference's
  trees on every reduced config (and granite at ``moe_every = 2``), with
  and without ``compress_dcn``;
* ``constrain`` is the identity without rules, ``use_rules`` nests,
  restores and is thread-local, and a spec maps onto DTensor placements
  in mesh-dim order only.
"""

import dataclasses
import threading
from types import SimpleNamespace

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config
from repro.configs.registry import ARCH_IDS
from repro.distributed import sharding as J
from repro.models import get_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import train_state_init as jtrain_state_init
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed import sharding as T
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import param_specs
from repro_torch.train import train_state_specs

SINGLE_POD = {"data": 16, "model": 16}
MULTI_POD = {"pod": 2, "data": 16, "model": 16}
# one config of each family
FAMILIES = ("qwen2-0.5b", "hubert-xlarge", "granite-moe-1b-a400m",
            "mamba2-130m", "jamba-v0.1-52b", "llama-3.2-vision-90b")


def _is_spec(t):
    return isinstance(t, tuple)


def _rules(shape: dict):
    """The reference's and the port's rules over the same axis sizes."""
    return (J.AxisRules(SimpleNamespace(shape=dict(shape)),
                        dict(J.DEFAULT_RULES)),
            T.AxisRules(dict(shape), dict(T.DEFAULT_RULES)))


def _same_spec(shape: dict, names, dims):
    jr, tr = _rules(shape)
    want, got = jr.spec(names, dims), tr.spec(names, dims)
    assert tuple(got) == tuple(want), (names, dims)
    assert tr.fallbacks == jr.fallbacks
    return got, tr.fallbacks


def _abstract(cfg, fn):
    """``fn(key)``'s (params, specs) with the params as shapes only: the
    specs are Python tuples, which ``eval_shape`` cannot return."""
    box = {}

    def f(key):
        params, box["specs"] = fn(key)
        return params
    shapes = jax.eval_shape(f, jax.random.PRNGKey(0))
    return shapes, box["specs"]


def test_default_rules_are_the_references():
    assert T.DEFAULT_RULES == J.DEFAULT_RULES


@pytest.mark.parametrize("shape,names,dims,want,fell", [
    # tests/test_sharding.py:18-37, mesh (data 2, model 4)
    ({"data": 2, "model": 4}, ("batch", None, "heads", None),
     (8, 16, 8, 64), ("data", None, "model", None), False),
    ({"data": 2, "model": 4}, ("batch", None, "heads", None),
     (8, 16, 9, 64), ("data", None, None, None), True),
    ({"data": 2, "model": 4}, ("batch", "fsdp"), (8, 8), ("data", None),
     False),
    # tests/test_sharding.py:40-54, mesh (pod 2, data 2, model 2)
    ({"pod": 2, "data": 2, "model": 2}, ("batch", None), (8, 4),
     (("pod", "data"), None), False),
    ({"pod": 2, "data": 2, "model": 2}, ("batch", None), (2, 4),
     ("pod", None), True),
    # qwen2-0.5b's 14 query heads over a 16-way model axis
    (SINGLE_POD, ("batch", None, "heads", None), (256, 1024, 14, 64),
     ("data", None, None, None), True),
    (MULTI_POD, ("batch", None, "kv_heads", None), (512, 1024, 2, 64),
     (("pod", "data"), None, None, None), True),
])
def test_spec_and_fallbacks_match_reference(shape, names, dims, want, fell):
    got, fallbacks = _same_spec(shape, names, dims)
    assert tuple(got) == want
    assert bool(fallbacks) == fell


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mesh", [SINGLE_POD, MULTI_POD],
                         ids=["16x16", "2x16x16"])
def test_family_spec_tree_on_production_meshes(arch, mesh):
    """Every parameter leaf at full width: the port's spec tree through
    the port's rules equals the reference's through the reference's."""
    cfg = get_config(arch)
    shapes, jspecs = _abstract(cfg, get_model(cfg).init)
    tspecs = param_specs(tget_config(arch))
    jr, tr = _rules(mesh)
    leaves = jax.tree.leaves(shapes)
    names = jax.tree.leaves(tspecs, is_leaf=_is_spec)
    assert names == jax.tree.leaves(jspecs, is_leaf=_is_spec)
    for n, leaf in zip(names, leaves):
        assert tuple(tr.spec(n, leaf.shape)) == tuple(jr.spec(n, leaf.shape))
    assert tr.fallbacks == jr.fallbacks


def _configs(arch):
    if arch == "granite-alt":
        kw = dict(moe_every=2, n_layers=4)
        return (dataclasses.replace(get_config("granite-moe-1b-a400m",
                                               reduced=True), **kw),
                dataclasses.replace(tget_config("granite-moe-1b-a400m",
                                                reduced=True), **kw))
    return get_config(arch, reduced=True), tget_config(arch, reduced=True)


@pytest.mark.parametrize("arch", ARCH_IDS + ("granite-alt",))
def test_param_specs_match_reference(arch):
    jc, tc = _configs(arch)
    shapes, want = _abstract(jc, get_model(jc).init)
    got = param_specs(tc)
    assert got == want
    # one name a dim of every leaf, on the reference's (and param_tree's)
    # layout
    assert (jax.tree.structure(got, is_leaf=_is_spec)
            == jax.tree.structure(shapes))
    for n, leaf in zip(jax.tree.leaves(got, is_leaf=_is_spec),
                       jax.tree.leaves(shapes)):
        assert len(n) == len(leaf.shape)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_state_specs_match_reference(arch, compress):
    jc, tc = _configs(arch)
    opt = JAdamWConfig()
    _, want = _abstract(jc, lambda key: jtrain_state_init(
        get_model(jc), key, opt, compress_dcn=compress))
    assert train_state_specs(tget_model(tc), compress_dcn=compress) == want


def test_constrain_noop_without_rules():
    x = torch.ones(4, 4)
    assert T.current_rules() is None
    assert T.constrain(x, "batch", None) is x
    assert T.constrain(x, "batch") is x          # no rules, no rank check
    assert T.spec_for(("batch", None), (4, 4)) == T.P()


def test_constrain_with_rules():
    x = torch.ones(8, 16)
    with T.use_rules({"data": 2, "model": 4}) as r:
        assert T.constrain(x, "batch", "ff") is x    # a plain tensor
        with pytest.raises(ValueError, match="2 names for rank-3"):
            T.constrain(torch.ones(2, 2, 2), "batch", None)
        assert tuple(T.spec_for(("batch", "ff"), (8, 16))) == \
            ("data", "model")
        assert r.fallbacks == []


def test_use_rules_nests_restores_and_is_thread_local():
    seen = {}
    with T.use_rules({"data": 2}) as outer:
        assert T.current_rules() is outer
        with T.use_rules({"model": 4}, overrides={"batch": ()}) as inner:
            assert T.current_rules() is inner
            assert inner.rules["batch"] == ()
            assert outer.rules["batch"] == ("pod", "data")
            t = threading.Thread(
                target=lambda: seen.setdefault("rules", T.current_rules()))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert T.current_rules() is outer
    assert T.current_rules() is None
    assert seen["rules"] is None


def test_logical_sharding_and_placements():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 2, 4))
    s = T.logical_sharding(mesh, ("batch", None, "heads"), (8, 3, 8))
    assert tuple(s.spec) == (("pod", "data"), None, "model")
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    s = T.logical_sharding(mesh, ("batch", "ff"), (8, 6),
                           overrides={"batch": ("data",)})
    assert tuple(s.spec) == ("data", None)
    assert s.placements == (Replicate(), Shard(0), Replicate())
    assert T.placements(mesh, T.P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        T.placements(mesh, T.P(("data", "pod"), None))
    with pytest.raises(ValueError, match="used twice"):
        T.placements(mesh, T.P("model", "model"))
