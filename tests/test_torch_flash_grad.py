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

import dataclasses
import math

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
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step, train_state_init

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


# ---------------------------------------------------------------------------
# the bf16 CUDA backward's tiling, mirrored in plain torch
# ---------------------------------------------------------------------------

# csrc/flash_attention_bwd.cu's bf16 route: a stats pass writes, per
# 64-query tile of a (batch, head), the rows' lse in log2 units and D =
# rowsum(dO * o), zeros past Sq.  dQ blocks (64-query tile, query head,
# batch), heaviest first, give alternate key tiles to two warpgroups and
# merge them; dK / dV blocks (64-key tile, kv head, batch), key tile 0
# first, give alternate (query head of the group, query tile) items to two
# warpgroups and merge them.  Ragged tiles arrive zero-filled (TMA); only
# the causal diagonal and the ragged last tiles are masked; P and dS are
# rounded to bf16 as product operands.  ``visits`` counts each (batch,
# query head, query, key) pair whose gradient terms each kernel computes.

BWD_TILE = 64               # the kernels' kRows
LOG2E = 1.4426950408889634


def _dq_blocks(B, Hq, Sq):
    """(query tile, query head, batch) of each dQ block, in launch order."""
    n_q = -(-Sq // BWD_TILE)
    return [(n_q - 1 - blk // (Hq * B), blk % Hq, blk // Hq % B)
            for blk in range(n_q * Hq * B)]


def _dkdv_blocks(B, Hkv, Skv):
    """(key tile, kv head, batch) of each dK / dV block, in launch order."""
    n_k = -(-Skv // BWD_TILE)
    return [(blk // (Hkv * B), blk % Hkv, blk // Hkv % B)
            for blk in range(n_k * Hkv * B)]


def _dkdv_items(kt, rep, n_q, causal):
    """The (query head offset in the group, query tile) items of key tile
    ``kt``, in the order the two warpgroups alternate over them."""
    qt0 = min(kt, n_q) if causal else 0
    per_head = n_q - qt0
    return [(it // per_head, qt0 + it % per_head)
            for it in range(rep * per_head)]


def _bwd_tile_mirror(q, k, v, o, dO, lse, causal, bf16, visits=None):
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep, T = Hq // Hkv, BWD_TILE
    n_q, n_k = -(-Sq // T), -(-Skv // T)
    scale_log2 = LOG2E / math.sqrt(hd)
    rnd = (lambda x: x.to(torch.bfloat16).float()) if bf16 else \
        (lambda x: x)

    def pad(t, n):                       # TMA's zero-filled rows
        out = torch.zeros(*t.shape[:2], n * T, hd)
        out[:, :, :t.shape[2]] = t.float()
        return out
    qp, dop, kp, vp = pad(q, n_q), pad(dO, n_q), pad(k, n_k), pad(v, n_k)
    stats = torch.zeros(B, Hq, n_q * T, 2)
    stats[:, :, :Sq, 0] = lse * LOG2E
    stats[:, :, :Sq, 1] = (dO.float() * o.float()).sum(-1)
    dq = torch.zeros(B, Hq, Sq, hd)
    dk, dv = torch.zeros(B, Hkv, Skv, hd), torch.zeros(B, Hkv, Skv, hd)

    def live_pairs(qpos, kpos, masked):
        live = torch.ones(len(qpos), len(kpos), dtype=torch.bool)
        if masked:
            live = (qpos[:, None] < Sq) & (kpos[None, :] < Skv)
            if causal:
                live &= kpos[None, :] <= qpos[:, None]
        return live

    def count(kind, b, h, qpos, kpos, live):
        if visits is not None:
            ok = live & (qpos[:, None] < Sq) & (kpos[None, :] < Skv)
            i, j = torch.nonzero(ok, as_tuple=True)
            visits[kind][b, h].index_put_((qpos[i], kpos[j]),
                                          torch.ones(len(i), dtype=torch.int32),
                                          accumulate=True)

    for qi, h, b in _dq_blocks(B, Hq, Sq):
        g, q0 = h // rep, qi * T
        qpos = torch.arange(q0, q0 + T)
        l2, D = stats[b, h, q0:q0 + T, 0], stats[b, h, q0:q0 + T, 1]
        n_t = -(-(min(Skv, q0 + T) if causal else Skv) // T)
        acc = [torch.zeros(T, hd), torch.zeros(T, hd)]
        for wg in (0, 1):
            for t in range(wg, n_t, 2):
                k0 = t * T
                kpos = torch.arange(k0, k0 + T)
                kt, vt = kp[b, g, k0:k0 + T], vp[b, g, k0:k0 + T]
                live = live_pairs(qpos, kpos, k0 + T > Skv or
                                  (causal and k0 + T - 1 > q0))
                p = torch.where(live, torch.exp2(
                    qp[b, h, q0:q0 + T] @ kt.T * scale_log2 - l2[:, None]),
                    0.0)
                ds = p * (dop[b, h, q0:q0 + T] @ vt.T - D[:, None])
                acc[wg] += rnd(ds) @ kt
                count("dq", b, h, qpos, kpos, live)
        n = min(T, Sq - q0)
        dq[b, h, q0:q0 + n] = ((acc[0] + acc[1]) / math.sqrt(hd))[:n]

    for kt_i, g, b in _dkdv_blocks(B, Hkv, Skv):
        k0 = kt_i * T
        kpos = torch.arange(k0, k0 + T)
        kt, vt = kp[b, g, k0:k0 + T], vp[b, g, k0:k0 + T]
        items = _dkdv_items(kt_i, rep, n_q, causal)
        acc_k = [torch.zeros(T, hd), torch.zeros(T, hd)]
        acc_v = [torch.zeros(T, hd), torch.zeros(T, hd)]
        for wg in (0, 1):
            for r, qt in items[wg::2]:
                h, q0 = g * rep + r, qt * T
                qpos = torch.arange(q0, q0 + T)
                qt_, dot = qp[b, h, q0:q0 + T], dop[b, h, q0:q0 + T]
                st = stats[b, h, q0:q0 + T]
                live = live_pairs(qpos, kpos, q0 + T > Sq or
                                  (causal and q0 < k0 + T)).T
                pt = torch.where(live, torch.exp2(
                    kt @ qt_.T * scale_log2 - st[None, :, 0]), 0.0)
                dst = pt * (vt @ dot.T - st[None, :, 1])
                acc_v[wg] += rnd(pt) @ dot
                acc_k[wg] += rnd(dst) @ qt_
                count("dkdv", b, h, qpos, kpos, live.T)
        n = min(T, Skv - k0)
        dk[b, g, k0:k0 + n] = ((acc_k[0] + acc_k[1]) / math.sqrt(hd))[:n]
        dv[b, g, k0:k0 + n] = (acc_v[0] + acc_v[1])[:n]
    return dq, dk, dv


# (B, Hq, Hkv, Sq, Skv, hd, causal): ragged tiles on both sides, causal
# with more queries than keys and the reverse (key tiles no query sees),
# GQA rep 1, 3 and 7, and enough tiles that both warpgroups work
TILE_CASES = [(2, 6, 2, 150, 150, 8, True),
              (1, 7, 1, 200, 130, 8, True),
              (1, 3, 3, 70, 200, 8, True),
              (2, 4, 4, 100, 170, 16, False),
              (1, 6, 2, 129, 129, 8, False)]
TILE_IDS = [f"B{c[0]}-{c[1]}/{c[2]}-{c[3]}x{c[4]}-hd{c[5]}-"
            f"{'causal' if c[6] else 'full'}" for c in TILE_CASES]


@pytest.mark.parametrize("case", TILE_CASES, ids=TILE_IDS)
def test_bwd_tile_mirror_matches_jax(case):
    """The kernels' order of work in float32 (no bf16 rounding) gives
    ``jax.vjp`` of the JAX ``ref.py`` within 1e-4."""
    *shape, causal = case
    q, k, v, do = _inputs(*shape)
    qt, kt, vt = _t(q), _t(k), _t(v)
    out, lse = attention_ref_lse(qt, kt, vt, causal=causal)
    got = _bwd_tile_mirror(qt, kt, vt, out, _t(do), lse, causal, bf16=False)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", TILE_CASES, ids=TILE_IDS)
def test_bwd_tile_mirror_bf16_within_the_cards_limit(case):
    """With bf16 inputs and P and dS rounded to bf16 as the kernels round
    them, each gradient stays within 2e-2 of its largest magnitude (the
    card's check, ``chip_smoke.BWD_REL_TOL``) of the plain backward."""
    *shape, causal = case
    q, k, v, do = (_t(a).to(torch.bfloat16).float() for a in _inputs(*shape))
    out, lse = attention_ref_lse(q, k, v, causal=causal)
    out = out.to(torch.bfloat16).float()       # the forward writes bf16
    got = _bwd_tile_mirror(q, k, v, out, do, lse, causal, bf16=True)
    want = attention_ref_backward(q, k, v, out, do, lse, causal=causal)
    for g, w in zip(got, want):
        lim = 2e-2 * w.abs().max().item()
        assert (g - w).abs().max().item() <= lim


@pytest.mark.parametrize("case", TILE_CASES, ids=TILE_IDS)
def test_bwd_tiles_visit_each_pair_once(case):
    """Each kernel computes every (query head, query, key) pair the mask
    allows exactly once, and none past it."""
    B, Hq, Hkv, Sq, Skv, hd, causal = case
    q, k, v, do = map(_t, _inputs(B, Hq, Hkv, Sq, Skv, hd))
    out, lse = attention_ref_lse(q, k, v, causal=causal)
    visits = {kind: torch.zeros(B, Hq, Sq, Skv, dtype=torch.int32)
              for kind in ("dq", "dkdv")}
    _bwd_tile_mirror(q, k, v, out, do, lse, causal, bf16=False,
                     visits=visits)
    i, j = torch.arange(Sq)[:, None], torch.arange(Skv)[None, :]
    allowed = ((j <= i) if causal else torch.ones(Sq, Skv, dtype=torch.bool))
    for kind, seen in visits.items():
        assert torch.equal(seen, allowed.int().expand(B, Hq, -1, -1)), kind


@pytest.mark.parametrize("S, heads", [(1024, (14, 2)), (1000, (16, 16)),
                                      (17, (14, 2)), (992, (64, 8))])
@pytest.mark.parametrize("causal", (True, False))
def test_bwd_grids_cover_each_tile_once_heaviest_first(S, heads, causal):
    """The two grids' index maps: every dQ (query tile, head, batch) and
    every dK / dV (key tile, kv head, batch) exactly once, in an order of
    non-increasing work under the causal mask."""
    B, (Hq, Hkv) = 8, heads
    n = -(-S // BWD_TILE)
    dq = _dq_blocks(B, Hq, S)
    assert sorted(dq) == [(t, h, b) for t in range(n) for h in range(Hq)
                          for b in range(B)]
    kv = _dkdv_blocks(B, Hkv, S)
    assert sorted(kv) == [(t, g, b) for t in range(n) for g in range(Hkv)
                          for b in range(B)]
    work_q = [t + 1 if causal else n for t, _, _ in dq]
    work_kv = [len(_dkdv_items(t, Hq // Hkv, n, causal)) for t, _, _ in kv]
    assert work_q == sorted(work_q, reverse=True)
    assert work_kv == sorted(work_kv, reverse=True)


# ---------------------------------------------------------------------------
# the model's operands reach the backward as TMA reads them
# ---------------------------------------------------------------------------

def _train_batch(cfg, B=2, S=72, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S))}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model))
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S))
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model))
    return {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f"
                                         else np.int64))
            for k, v in batch.items()}


@pytest.mark.parametrize("arch, head_dim", [("qwen2-0.5b", 64),
                                            ("llama-3.2-vision-90b", 128),
                                            ("hubert-xlarge", 80)])
def test_model_operands_meet_the_tma_conditions(monkeypatch, arch,
                                                head_dim):
    """A reduced model, at a head width the kernels take and in bf16, run
    forward and backward on the CPU: the q, k, v, o and dO of every call
    of ``flash_attention_backward`` are bf16 with hd contiguous and
    16-byte bases and (batch, head, seq) strides (``ops.check_tma``), so
    on the card TMA reads them in place and no dO is copied."""
    cfg = dataclasses.replace(tget_config(arch, reduced=True),
                              head_dim=head_dim, compute_dtype="bfloat16")
    model = tget_model(cfg)
    seen, real = [], fa.flash_attention_backward

    def spy(q, k, v, o, dO, lse, *, causal=True):
        seen.append((q, k, v, o, dO))
        return real(q, k, v, o, dO, lse, causal=causal)
    monkeypatch.setattr(fa, "flash_attention_backward", spy)
    opt = AdamWConfig()
    state = train_state_init(model, torch.Generator().manual_seed(0), opt,
                             device="cpu")
    copies = fa.dout_copies
    make_train_step(model, opt).value_and_grad(state["params"],
                                               _train_batch(cfg))
    assert len(seen) == cfg.n_layers
    for args in seen:
        for name, t in zip(("q", "k", "v", "o", "dO"), args):
            assert t.dtype == torch.bfloat16 and t.shape[-1] == head_dim
            fa.check_tma(t, name)
        assert fa._rows_ok(args[4])
    assert fa.dout_copies == copies
