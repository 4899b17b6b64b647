"""The gradient of the port's flash attention on the CPU: the plain
backward ``attention_ref_backward`` and the ``flash_attention`` autograd
function (on a CPU tensor its forward is ``attention_ref_lse`` and its
backward ``attention_ref_backward``, the equations the CUDA kernels
implement), held against torch autograd through ``attention_ref`` and
against ``jax.vjp`` of the JAX package's ``repro.kernels.flash_attention.
ref.attention_ref``; and the log-sum-exp of ``attention_ref_lse`` against
a float64 numpy reference.  Inputs come from numpy seeds and go to all
sides.

Cases: causal and not, Sq != Skv both ways, GQA rep 1, 3 and 7, hd 8 and
64.  Tolerances (float32 everywhere; sums run in different orders): 2e-5
abs and rel against torch autograd, 1e-4 against JAX, 1e-5 on the LSE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_ref,
                                                 attention_ref_backward,
                                                 attention_ref_lse,
                                                 flash_attention)

# (B, Hq, Hkv, Sq, Skv, hd, causal)
CASES = [(2, 3, 3, 9, 9, 8, True),
         (1, 6, 2, 7, 12, 8, False),
         (2, 7, 1, 13, 13, 64, True),
         (1, 14, 2, 12, 5, 64, True),       # causal, more queries than keys
         (1, 3, 1, 5, 11, 64, False),
         (2, 2, 2, 16, 16, 64, False)]
IDS = [f"B{c[0]}-{c[1]}/{c[2]}-{c[3]}x{c[4]}-hd{c[5]}-"
       f"{'causal' if c[6] else 'full'}" for c in CASES]


def _inputs(B, Hq, Hkv, Sq, Skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return n(B, Hq, Sq, hd), n(B, Hkv, Skv, hd), n(B, Hkv, Skv, hd), \
        n(B, Hq, Sq, hd)


def _t(a, grad=False):
    return torch.from_numpy(a.copy()).requires_grad_(grad)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_autograd(case):
    *shape, causal = case
    q, k, v, do = map(_t, _inputs(*shape))
    out, lse = attention_ref_lse(q, k, v, causal=causal)
    got = attention_ref_backward(q, k, v, out, do, lse, causal=causal)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(attention_ref(qg, kg, vg, causal=causal),
                               (qg, kg, vg), do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_function_matches_jax(case):
    *shape, causal = case
    q, k, v, do = _inputs(*shape)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = flash_attention(qt, kt, vt, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    jout, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_matches_float64(case):
    B, Hq, Hkv, Sq, Skv, hd, causal = case
    q, k, v, _ = _inputs(B, Hq, Hkv, Sq, Skv, hd)
    _, lse = attention_ref_lse(_t(q), _t(k), _t(v), causal=causal)
    rep = Hq // Hkv
    s = np.einsum("bgrqh,bgkh->bgrqk",
                  q.astype(np.float64).reshape(B, Hkv, rep, Sq, hd),
                  k.astype(np.float64)) / np.sqrt(hd)
    if causal:
        s = np.where(np.arange(Skv)[None] <= np.arange(Sq)[:, None], s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, Sq)
    np.testing.assert_allclose(lse.numpy(), want.reshape(B, Hq, Sq),
                               rtol=1e-5, atol=1e-5)


def test_no_graph_without_grad():
    """Serving: no input requires grad (or grad mode is off) -> the plain
    forward, no autograd node and no LSE; the kernel counters untouched on
    the CPU."""
    q, k, v, _ = map(_t, _inputs(1, 2, 1, 4, 4, 8))
    n = (fa.launches, fa.bwd_launches)
    out = flash_attention(q, k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, attention_ref(q, k, v), rtol=0, atol=0)
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(True), k, v).grad_fn is None
    assert (fa.launches, fa.bwd_launches) == n
    assert issubclass(FlashAttention, torch.autograd.Function)


def test_backward_through_model_layout():
    """The model's layout: (B, S, H, hd) activations as transposed views,
    the output reshaped back, as ``attention_apply`` does; the gradient of
    every input equals autograd through the plain forward."""
    B, S, Hq, Hkv, hd = 2, 6, 4, 2, 8
    rng = np.random.default_rng(3)
    x = {n: _t(rng.standard_normal((B, S, h, hd)).astype(np.float32), True)
         for n, h in (("q", Hq), ("k", Hkv), ("v", Hkv))}
    w = _t(rng.standard_normal((B, S, Hq * hd)).astype(np.float32))

    def loss(fn):
        out = fn(*(x[n].transpose(1, 2) for n in "qkv"), causal=True)
        return (out.transpose(1, 2).reshape(B, S, Hq * hd) * w).sum()
    got = torch.autograd.grad(loss(flash_attention), list(x.values()))
    want = torch.autograd.grad(loss(attention_ref), list(x.values()))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-5,
                                   atol=2e-5)
