"""The port's audio family (``repro_torch.models.transformer`` with
``family == "audio"``) and ``Model.forward`` on the CPU, held against the
JAX package with the same inputs and weights (carried over by
``params_from_numpy``), on ``hubert-xlarge`` reduced (2 layers, d_model
64, 4 heads of 16, LayerNorm, gelu, qkv biases, 64-way head):

* ``forward`` logits (the ``head``) and ``prefill`` logits (``lm_head`` on
  the last frame, as the reference does) and K/V caches from frames;
* the dense ``forward`` on ``qwen2-0.5b`` reduced;
* the ``flash_attention`` plain version at hd 80 (hubert-xlarge's 1280 /
  16, the width the CUDA kernel runs on 128-wide zero-filled tiles)
  against the reference's ``ref.py`` and its Pallas kernel in interpret
  mode;
* checkpoint files byte-identical, and ``params_to_numpy`` inverting
  ``params_from_numpy``;
* the ``ServeEngine`` serving the audio model from frames in a request's
  ``extras`` (12 seeded frames, ``max_seq`` 32, chunks of 2, 3 new
  tokens): an empty and a 12-token prompt give the JAX engine's tokens,
  and a session moved after its first step, in process or over the wire
  (from either package), continues the unmigrated stream.

The qkv, LayerNorm and MLP biases are zero at init, which would hide a
bias that is dropped or misplaced: every test sets them to nonzero draws
in the numpy tree before converting it to both packages.  Float32 on both
sides; the tolerances (1e-4 on logits and caches, 1e-5 on attention
outputs) cover summation order only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import get_model
from repro.serve import Request, ServeEngine
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

ARCH = "hubert-xlarge"
TOL = 1e-4
# the leaves zero at init, drawn nonzero for every test
BIASES = (("layers", "attn", "bq"), ("layers", "attn", "bk"),
          ("layers", "attn", "bv"), ("layers", "ln1", "bias"),
          ("layers", "ln2", "bias"), ("layers", "mlp", "b_in"),
          ("layers", "mlp", "b_out"), ("ln_f", "bias"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """Per arch: the reference (model, params) and the port's, same
    weights (for audio with every bias nonzero); built once per module."""
    cache = {}

    def get(arch=ARCH):
        if arch not in cache:
            jm = get_model(get_config(arch, reduced=True))
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.array, params)
            rng = np.random.default_rng(11)
            if jm.cfg.family == "audio":
                for path in BIASES:
                    d = tree
                    for key in path[:-1]:
                        d = d[key]
                    assert not d[path[-1]].any(), path     # zero at init
                    d[path[-1]] = 0.3 * rng.standard_normal(
                        d[path[-1]].shape).astype(np.float32)
                params = jax.tree.map(jnp.asarray, tree)
            tc = tget_config(arch, reduced=True)
            cache[arch] = (jm, params, tget_model(tc),
                           params_from_numpy(tc, tree, "cpu"))
        return cache[arch]
    return get


def _frames(cfg, B, T, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_model_surface():
    tm = tget_model(tget_config(ARCH, reduced=True))
    assert tm.prefill_chunk is None          # frames prefill whole
    assert not tm.cfg.causal
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert tuple(tp.head.shape) == (tm.cfg.d_model, tm.cfg.vocab)
    out = tm.forward(tp, {"frames": torch.zeros(1, 3, tm.cfg.d_model)})
    assert tuple(out.shape) == (1, 3, tm.cfg.vocab)


@pytest.mark.parametrize("B,T", [(2, 11), (1, 32)])
def test_forward_logits_match_jax(pair, B, T):
    jm, params, tm, tp = pair()
    fr = _frames(tm.cfg, B, T, seed=T)
    want = jax.jit(jm.forward)(params, {"frames": jnp.asarray(fr)})
    got = tm.forward(tp, {"frames": torch.from_numpy(fr)})
    assert got.shape == want.shape == (B, T, tm.cfg.vocab)
    _close(got, want)


def test_prefill_logits_and_caches_match_jax(pair):
    jm, params, tm, tp = pair()
    fr = _frames(tm.cfg, 2, 13, seed=5)
    jl, jc = jax.jit(jm.prefill)(params, {"frames": jnp.asarray(fr)})
    tl, tc = tm.prefill(tp, {"frames": torch.from_numpy(fr)})
    assert tl.shape == jl.shape == (2, 1, tm.cfg.vocab)
    _close(tl, jl)
    assert tc.keys() == jc.keys() == {"k", "v"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name])
    # prefill's lm_head is not forward's head: the two logits differ
    full = tm.forward(tp, {"frames": torch.from_numpy(fr)})
    assert not torch.allclose(full[:, -1:], tl)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "smollm-135m"])
def test_dense_forward_matches_jax(pair, arch):
    jm, params, tm, tp = pair(arch)
    tokens = np.random.default_rng(2).integers(0, tm.cfg.vocab, (2, 9))
    want = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(tokens)})
    got = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape == (2, 9, tm.cfg.vocab)
    _close(got, want)
    last, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)})
    _close(last, got[:, -1:].numpy())


# ---------------------------------------------------------------------------
# flash attention at hd 80
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", (False, True))
@pytest.mark.parametrize("B,H,Sq,Skv", [(1, 2, 32, 32), (2, 3, 48, 16),
                                        (1, 2, 37, 37)])
def test_flash_attention_plain_at_hd_80_matches_jax(causal, B, H, Sq, Skv):
    hd = 80
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, H, Skv, hd)).astype(np.float32)
    v = rng.standard_normal((B, H, Skv, hd)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    n0 = fa.launches
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    assert fa.launches == n0 and hd in fa.HEAD_DIMS
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ref(jq, jk, jv, causal=causal)), atol=1e-5, rtol=0)
    if Sq % 16 == 0 and Skv % 16 == 0:    # the Pallas kernel's tiling rule
        pallas = np.asarray(jax_flash(jq, jk, jv, causal=causal, block_q=16,
                                      block_k=16, force_pallas=True))
        np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# checkpoints and conversion
# ---------------------------------------------------------------------------

def _files(step_dir):
    return {name: open(os.path.join(step_dir, name), "rb").read()
            for name in sorted(os.listdir(step_dir))}


def test_checkpoint_byte_identical_and_cross_loading(pair, tmp_path):
    jm, params, tm, tp = pair()
    jd = jstore.save_checkpoint(str(tmp_path / "jax"), 2, params)
    td = tstore.save_checkpoint(str(tmp_path / "port"), 2,
                                params_to_numpy(tm.cfg, tp))
    jf, tf = _files(jd), _files(td)
    assert tf.keys() == jf.keys()
    for name in jf:
        assert tf[name] == jf[name], name
    tree, _ = tstore.load_checkpoint(str(tmp_path / "jax"), 2,
                                     params_to_numpy(tm.cfg, tp),
                                     device="cpu")
    tp2 = params_from_numpy(tm.cfg, tree, "cpu")
    mine, back = dict(tp.named_parameters()), dict(tp2.named_parameters())
    assert mine.keys() == back.keys() and "head" in mine
    for n, a in mine.items():
        assert torch.equal(a, back[n]), n
    jparams, _ = jstore.load_checkpoint(str(tmp_path / "port"), 2, params)
    fr = _frames(tm.cfg, 1, 9, seed=1)
    want = jax.jit(jm.forward)(jparams, {"frames": jnp.asarray(fr)})
    _close(tm.forward(tp, {"frames": torch.from_numpy(fr)}), want)


def test_params_to_numpy_inverts_params_from_numpy(pair):
    _, params, tm, tp = pair()
    tree = jax.tree.map(np.asarray, params)
    assert tree["head"].shape == (tm.cfg.d_model, tm.cfg.vocab)
    back = params_to_numpy(tm.cfg, params_from_numpy(tm.cfg, tree, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

N_FRAMES = 12


def _audio_request(req_cls, cfg, plen, max_new=3):
    """A request whose ``extras`` carry 12 seeded frames (the audio
    prefill reads them, not the prompt's ids); ``plen`` prompt tokens."""
    frames = _frames(cfg, 1, N_FRAMES, seed=21)[0]
    prompt = np.random.default_rng(22).integers(0, cfg.vocab, plen)
    return req_cls(rid=0, prompt=prompt, max_new=max_new,
                   extras={"frames": frames})


def _audio_engine(entry, kind, decode_chunk=2):
    jm, params, tm, tp = entry
    if kind == "jax":
        return ServeEngine(jm, params, max_batch=2, max_seq=32,
                           decode_chunk=decode_chunk), Request
    return TServeEngine(tm, tp, max_batch=2, max_seq=32,
                        decode_chunk=decode_chunk), TRequest


@pytest.mark.parametrize("plen", (0, N_FRAMES))
def test_engine_tokens_match_jax(pair, plen):
    """Both engines serve the audio model from the request's frames and
    give the same greedy tokens, for an empty and a 12-token prompt."""
    out = {}
    for kind in ("jax", "torch"):
        eng, req_cls = _audio_engine(pair(), kind)
        req = _audio_request(req_cls, eng.model.cfg, plen)
        eng.submit(req)
        eng.run_until_drained(max_steps=50)
        assert req.done
        out[kind] = list(req.out_tokens)
    assert len(out["torch"]) == 3
    assert all(0 <= t < pair()[2].cfg.vocab for t in out["torch"])
    assert out["torch"] == out["jax"], out


@pytest.mark.parametrize("src,how", [("torch", "in-process"),
                                     ("torch", "wire"), ("jax", "wire")])
def test_migrated_session_continues_the_stream(pair, src, how):
    """A session exported after its first step (the prefill token and one
    decode token) and resumed on a port engine finishes with the JAX
    engine's unmigrated tokens; its frames travel in ``extras``."""
    entry = pair()
    jeng, _ = _audio_engine(entry, "jax", decode_chunk=1)
    want = _audio_request(Request, jeng.model.cfg, N_FRAMES)
    jeng.submit(want)
    jeng.run_until_drained(max_steps=50)
    a, req_cls = _audio_engine(entry, src, decode_chunk=1)
    b, _ = _audio_engine(entry, "torch", decode_chunk=1)
    req = _audio_request(req_cls, a.model.cfg, N_FRAMES)
    a.submit(req)
    a.step()
    assert 0 < len(req.out_tokens) < 3
    if how == "wire":
        b.import_session_wire(a.export_session_wire(0))
        req = b.sessions_in[-1].req
        np.testing.assert_array_equal(req.extras["frames"],
                                      _frames(entry[2].cfg, 1, N_FRAMES,
                                              seed=21)[0])
    else:
        b.import_session(a.export_session(0))
    b.run_until_drained(max_steps=50)
    assert req.done and list(req.out_tokens) == list(want.out_tokens)
