"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_ep``) on
the CPU, held against the JAX package's ``repro.models.moe.moe_ep``.

* without rules ``moe_ep`` is the one-column ``moe_apply``, bit for bit,
  and ``moe_ffn`` routes as before (no collective);
* under rules on gloo meshes of (data, model) = (1, 2), (2, 2) and
  (1, 4) ranks (``run_ranks``), every rank's output equals the
  reference's ``moe_ep`` under ``use_rules`` on a mesh of the same shape
  (fake XLA devices in a subprocess) within 1e-5, at capacity factor 16
  and at 1.0, where copies drop (capacity is per block, so there the
  result differs from the one-column function's);
* ``moe_ffn`` under rules takes ``moe_ep`` (two ``all_to_all_single``
  calls) only for a prefill of more than 4096 tokens;
* the reference's dense fallbacks (experts or sequence not divisible by
  the model axis, batch not divisible by the batch axes, no model axis),
  in process with a name -> size mapping for the mesh.

The layer is ``tests/test_moe.py``'s (8 experts top-2, d_model 32),
float32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from conftest import run_subprocess
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as JM
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.distributed.ranks import run_ranks
from repro_torch.distributed.sharding import use_rules
from repro_torch.models import moe as TM

CFG = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab=64, n_experts=8, top_k=2,
           d_expert=16, capacity_factor=16.0, param_dtype="float32",
           compute_dtype="float32")
FACTORS = (16.0, 1.0)
MESHES = ((1, 2), (2, 2), (1, 4))
TIMEOUT = 60.0


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def layer():
    p, _ = JM.moe_init(JModelConfig(**CFG), jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}, _x((4, 8, 32), 1)


def _port(params, cf=16.0):
    cfg = TModelConfig(**dict(CFG, capacity_factor=cf))
    return cfg, TM.MoE(cfg, {k: torch.from_numpy(v)
                             for k, v in params.items()})


@pytest.fixture(scope="module")
def reference(layer, tmp_path_factory):
    """The reference's ``moe_ep`` on each mesh shape and factor, on 4
    fake XLA devices in one subprocess."""
    d = tmp_path_factory.mktemp("moe_ep")
    params, x = layer
    np.savez(d / "in.npz", x=x, **params)
    run_subprocess(f"""
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.base import ModelConfig
    from repro.distributed.sharding import use_rules
    from repro.models import moe as M
    z = np.load({str(d / "in.npz")!r})
    p = {{k: jnp.asarray(z[k]) for k in z.files if k != "x"}}
    x = jnp.asarray(z["x"])
    out = {{}}
    for shape in {MESHES!r}:
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        for cf in {FACTORS!r}:
            cfg = ModelConfig(**dict({CFG!r}, capacity_factor=cf))
            with use_rules(mesh), mesh:
                y = jax.jit(lambda p, x: M.moe_ep(cfg, p, x))(p, x)
            out[f"{{shape[0]}}x{{shape[1]}}_{{cf}}"] = np.asarray(y)
    np.savez({str(d / "out.npz")!r}, **out)
    print("OK")
    """, devices=4)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("shape", [(4, 8, 32), (2, 2050, 32)])
def test_without_rules_moe_ep_is_moe_apply(layer, shape):
    params, _ = layer
    cfg, p = _port(params, cf=1.0)
    x = torch.from_numpy(_x(shape, 2))
    n0 = TM.a2a_calls
    want = TM.moe_apply(cfg, p, x)
    assert torch.equal(TM.moe_ep(cfg, p, x), want)
    assert torch.equal(TM.moe_ffn(cfg, p, x), want)
    assert TM.a2a_calls == n0


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_moe_ep_matches_reference_on_mesh(layer, reference, shape):
    params, x = layer
    x_big = _x((2, 2052, 32), 3)
    outs = run_ranks(ranks.moe_ep_body, shape[0] * shape[1], shape,
                     dict(CFG, capacity_factor=list(FACTORS)), params, x,
                     x_big, device="cpu", timeout=TIMEOUT)
    for cf in FACTORS:
        want = reference[f"{shape[0]}x{shape[1]}_{cf}"]
        for rank, out in enumerate(outs):
            np.testing.assert_allclose(out[cf], want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank}, factor {cf}")
    # capacity per block: at factor 1.0 copies drop, and the blocks' drops
    # are not the one-column function's
    cfg, p = _port(params, cf=1.0)
    dense = TM.moe_apply(cfg, p, torch.from_numpy(x)).numpy()
    assert np.abs(outs[0][1.0] - dense).max() > 1e-3
    # moe_ffn at factor 16 (no drops): a prefill of 4104 tokens goes
    # expert-parallel, a decode step and a 4096-token prefill do not
    assert outs[0]["a2a"] == {"prefill": 2, "decode": 0, "4096": 0}
    cfg, p = _port(params, cf=FACTORS[0])
    big = TM.moe_apply(cfg, p, torch.from_numpy(x_big)).numpy()
    np.testing.assert_allclose(outs[0]["prefill"], big, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mesh,shape", [
    ({"data": 1, "model": 3}, (4, 6, 32)),        # E % n_cols
    ({"data": 1, "model": 2}, (4, 7, 32)),        # S % n_cols
    ({"data": 3, "model": 2}, (4, 8, 32)),        # B % n_batch
    ({"pod": 2, "data": 2}, (4, 8, 32)),          # no model axis
])
def test_dense_fallbacks(layer, mesh, shape):
    params, _ = layer
    cfg, p = _port(params, cf=1.0)
    x = _x(shape, 4)
    jcfg = JModelConfig(**dict(CFG, capacity_factor=1.0))
    want = np.asarray(JM.moe_dense(jcfg, {k: jnp.asarray(v) for k, v in
                                          params.items()}, jnp.asarray(x)))
    n0 = TM.a2a_calls
    with use_rules(mesh):
        got = TM.moe_ep(cfg, p, torch.from_numpy(x))
    assert TM.a2a_calls == n0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, TM.moe_apply(cfg, p, torch.from_numpy(x)))
