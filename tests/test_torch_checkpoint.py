"""The port's checkpoints (``repro_torch.checkpoint``) and parameter
conversion (``repro_torch.models.convert``) on the CPU, held against the
JAX package's ``repro.checkpoint``:

* the same tree written by both packages gives byte-identical shards and
  manifests, in zlib and in zstd;
* each package loads the other's checkpoint, bfloat16 leaves bit for bit;
* ``params_to_numpy(params_from_numpy(t))`` is ``t`` leaf for leaf (dense
  and MoE trees), and a checkpoint of the port's parameters loads through
  the JAX package's ``load_checkpoint(target_tree=init(...))`` into a model
  whose logits are the reference's;
* a missing leaf raises ``KeyError``, a wrong shape ``ValueError``; a
  manifest without a codec means zstd; ``AsyncCheckpointer`` keeps
  ``keep`` steps.

Bytes and leaves are exact; the logits compare within 1e-5 (float32,
summation order only).
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config
from repro.models import get_model
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy

ARCHS = ("qwen2-0.5b", "starcoder2-15b", "granite-moe-1b-a400m",
         "qwen3-moe-235b-a22b")


def _trees():
    """One tree in both packages' leaf types: numpy where numpy has the
    dtype; bfloat16 as ``ml_dtypes`` (JAX) and as a torch tensor (port).
    Keys are unsorted and nested, with a list, to exercise the path
    order."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((2, 5)).astype(np.float32)
    common = {"zeta": {"b": np.arange(6, dtype=np.int32).reshape(2, 3),
                       "a": w},
              "alpha": [np.float32(2.5) * np.ones(3, np.float32),
                        np.arange(4, dtype=np.int64)]}
    jtree = {**common, "half": h.astype(ml_dtypes.bfloat16)}
    ttree = {**common, "half": torch.from_numpy(h).to(torch.bfloat16)}
    return jtree, ttree


def _files(step_dir):
    return {name: open(os.path.join(step_dir, name), "rb").read()
            for name in sorted(os.listdir(step_dir))}


@pytest.mark.parametrize("codec", ("zlib", "zstd"))
def test_checkpoint_files_byte_identical_across_packages(tmp_path,
                                                         monkeypatch, codec):
    if codec == "zstd" and (jstore.zstd is None or tstore.zstd is None):
        pytest.skip("zstandard is not importable here")
    monkeypatch.setattr(jstore, "_DEFAULT_CODEC", codec)
    monkeypatch.setattr(tstore, "_DEFAULT_CODEC", codec)
    jtree, ttree = _trees()
    jd = jstore.save_checkpoint(str(tmp_path / "jax"), 7, jtree,
                                extra={"data_pos": 11})
    td = tstore.save_checkpoint(str(tmp_path / "port"), 7, ttree,
                                extra={"data_pos": 11})
    jf, tf = _files(jd), _files(td)
    assert tf.keys() == jf.keys()
    assert len(tf) == 5                       # 4 shards + the manifest
    for name in jf:
        assert tf[name] == jf[name], name
    manifest = json.loads(tf["manifest.json"])
    assert manifest["codec"] == codec
    assert list(manifest["index"]) == ["alpha/0", "alpha/1", "half",
                                       "zeta/a", "zeta/b"]
    assert manifest["index"]["half"]["dtype"] == "bfloat16"


def _assert_bits(t: torch.Tensor, a: np.ndarray):
    """A loaded tensor against a numpy leaf, bit for bit."""
    a = np.asarray(a)
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    else:
        assert t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.numpy(), a)


def test_each_package_loads_the_others(tmp_path):
    jtree, ttree = _trees()
    jstore.save_checkpoint(str(tmp_path / "jax"), 3, jtree)
    tstore.save_checkpoint(str(tmp_path / "port"), 3, ttree)
    # the port reads the JAX package's checkpoint
    got, extra = tstore.load_checkpoint(str(tmp_path / "jax"), 3, jtree,
                                        device="cpu")
    assert extra == {}
    flat_j = jax.tree_util.tree_leaves(jtree)
    flat_t = [got["alpha"][0], got["alpha"][1], got["half"], got["zeta"]["a"],
              got["zeta"]["b"]]
    for t, a in zip(flat_t, flat_j):
        _assert_bits(t, a)
    # and the JAX package reads the port's, bfloat16 as ml_dtypes
    back, _ = jstore.load_checkpoint(str(tmp_path / "port"), 3, jtree)
    for b, a in zip(jax.tree_util.tree_leaves(back), flat_j):
        b, a = np.asarray(b), np.asarray(a)
        # int64 lands as JAX's canonical int32, as from its own checkpoint
        a = a.astype(jax.dtypes.canonicalize_dtype(a.dtype))
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8))


def test_missing_leaf_and_wrong_shape_raise(tmp_path):
    _, ttree = _trees()
    tstore.save_checkpoint(str(tmp_path), 1, ttree)
    with pytest.raises(KeyError, match="extra"):
        tstore.load_checkpoint(str(tmp_path), 1,
                               {**ttree, "extra": np.zeros(2)}, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tstore.load_checkpoint(str(tmp_path), 1,
                               {**ttree, "half": np.zeros((5, 2))},
                               device="cpu")


def test_manifest_without_codec_means_zstd(tmp_path, monkeypatch):
    if tstore.zstd is None:
        pytest.skip("zstandard is not importable here")
    monkeypatch.setattr(tstore, "_DEFAULT_CODEC", "zstd")
    _, ttree = _trees()
    d = tstore.save_checkpoint(str(tmp_path), 2, ttree)
    path = os.path.join(d, "manifest.json")
    manifest = json.load(open(path))
    del manifest["codec"]
    json.dump(manifest, open(path, "w"))
    got, _ = tstore.load_checkpoint(str(tmp_path), 2, ttree, device="cpu")
    assert torch.equal(got["half"], ttree["half"])
    assert tstore.compress(b"x" * 100, "zlib") == jstore.compress(
        b"x" * 100, "zlib")
    with pytest.raises(ValueError, match="unknown codec"):
        tstore.compress(b"x", "lz4")


def test_async_checkpointer_keeps_the_last_steps(tmp_path):
    _, ttree = _trees()
    ck = tstore.AsyncCheckpointer(str(tmp_path), n_shards=2, keep=2)
    assert tstore.latest_step(str(tmp_path)) is None
    live, saved = ttree["zeta"]["a"], []
    for step in range(4):
        ck.save(step, ttree, extra={"step": step})
        saved.append(live.copy())
        live += 1.0                     # the snapshot is taken at save()
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    assert tstore.latest_step(str(tmp_path)) == 3
    got, extra = tstore.load_checkpoint(str(tmp_path), 2, ttree,
                                        device="cpu")
    assert extra == {"step": 2}
    np.testing.assert_array_equal(got["zeta"]["a"].numpy(), saved[2])


# ---------------------------------------------------------------------------
# model parameters
# ---------------------------------------------------------------------------

def _reference(arch):
    jm = get_model(get_config(arch, reduced=True))
    params = jax.jit(lambda key: jm.init(key)[0])(jax.random.PRNGKey(0))
    return jm, params


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    jm, params = _reference(arch)
    tree = jax.tree.map(np.asarray, params)
    tc = tget_config(arch, reduced=True)
    back = params_to_numpy(tc, params_from_numpy(tc, tree, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "granite-moe-1b-a400m"))
def test_port_checkpoint_loads_into_the_reference(tmp_path, arch):
    """A checkpoint of the port's own random parameters loads through the
    JAX package's ``load_checkpoint(target_tree=init(...))``; the
    reference's prefill logits on it are the port's; and the port reads it
    back into the same parameters."""
    tc = tget_config(arch, reduced=True)
    tm = tget_model(tc)
    tp = tm.init(torch.Generator().manual_seed(3), "cpu")
    tstore.save_checkpoint(str(tmp_path), 5, params_to_numpy(tc, tp))
    jm, init_params = _reference(arch)
    jparams, _ = jstore.load_checkpoint(str(tmp_path), 5, init_params)
    tokens = np.random.default_rng(1).integers(0, tc.vocab, (1, 9))
    jl, _ = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(tokens)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    tree, _ = tstore.load_checkpoint(str(tmp_path), 5,
                                     params_to_numpy(tc, tp), device="cpu")
    tp2 = params_from_numpy(tc, tree, "cpu")
    mine, back = dict(tp.named_parameters()), dict(tp2.named_parameters())
    assert mine.keys() == back.keys()
    for n, a in mine.items():
        assert torch.equal(a, back[n]), n
    tl2, _ = tm.prefill(tp2, {"tokens": torch.from_numpy(tokens)})
    assert torch.equal(tl2, tl)
