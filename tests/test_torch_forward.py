"""The port's training compute on the CPU: ``Model.forward`` and the
gradient of the loss for all six families, held against the JAX package's
``forward`` and ``jax.value_and_grad`` with the same weights (the
reference's numpy tree, carried over by ``params_from_numpy``) and the
same numpy-seeded tokens, frames, images and labels.

Families: dense (qwen2-0.5b, smollm-135m), MoE (granite-moe-1b-a400m at
``moe_every`` 1, and 2 with 4 layers), SSM (mamba2-130m), hybrid (jamba at
8 layers), vlm (llama-3.2-vision-90b, its cross gates set nonzero in the
tree: zero would hide the cross path) and audio (hubert-xlarge, its qkv,
LayerNorm and MLP biases set nonzero), every one reduced.  The port's
gradients come from ``TrainStep.value_and_grad``: autograd through the
flash-attention ``autograd.Function`` (its plain backward on the CPU) and
the rematerialized blocks, stacked back into the reference's tree, so
every leaf is compared, ``wq`` / ``wk`` / ``wv`` included.

The JAX package's SSD scan (``repro.models.mamba2._ssd_chunked``) masks
``exp(cum_q - cum_k)`` above the diagonal after the ``exp``; at these
sizes the exponent overflows there, and its gradient is NaN in every leaf
below the SSM layers (``inf * 0`` in the backward; the reference's
forward is unaffected).  The port masks before the ``exp``.  For the SSM
and hybrid families the reference gradient is therefore taken with the
module's ``jnp.exp`` clamping its argument at 80: every exponent the scan
uses is <= 0, so only the masked entries change, and the fixture checks
that the JAX logits are the same with and without the clamp.

Tolerances (float32 on both sides; products and sums run in different
orders): logits and loss 1e-4 abs and rel; each gradient leaf within 1e-4
of that leaf's largest magnitude in the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import get_model
from repro.models import mamba2 as jmamba2
from repro.train.losses import cross_entropy
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import make_train_step

B, S = 2, 16
TOL = 1e-4
AUDIO_BIASES = (("layers", "attn", "bq"), ("layers", "attn", "bk"),
                ("layers", "attn", "bv"), ("layers", "ln1", "bias"),
                ("layers", "ln2", "bias"), ("layers", "mlp", "b_in"),
                ("layers", "mlp", "b_out"), ("ln_f", "bias"))
VLM_GATES = {"gate_attn": [0.7, 0.5], "gate_mlp": [-0.4, 0.3]}
CASES = {                       # id -> (arch, config changes)
    "qwen2": ("qwen2-0.5b", {}),
    "smollm": ("smollm-135m", {}),
    "granite": ("granite-moe-1b-a400m", {}),
    "granite-alt": ("granite-moe-1b-a400m", {"moe_every": 2,
                                             "n_layers": 4}),
    "mamba2": ("mamba2-130m", {}),
    "jamba": ("jamba-v0.1-52b", {"n_layers": 8}),
    "vlm": ("llama-3.2-vision-90b", {}),
    "audio": ("hubert-xlarge", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get_path(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set_path(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def _inputs(cfg, seed=0):
    """numpy batch for the family: tokens or frames, labels, images."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


class _ClampedExp:
    """``jax.numpy`` with ``exp``'s argument clamped at 80 (see the module
    docstring)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jnp.exp(jnp.minimum(x, 80.0))


def _fwd_batch(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module")
def reference():
    """Per case, built once: (port config, numpy weights, numpy batch, JAX
    logits, JAX loss, JAX gradient tree)."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, changes = CASES[case]
            jc = dataclasses.replace(get_config(arch, reduced=True),
                                     **changes)
            tc = dataclasses.replace(tget_config(arch, reduced=True),
                                     **changes)
            jm = get_model(jc)
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.array, params)
            rng = np.random.default_rng(11)
            if jc.family == "audio":
                for path in AUDIO_BIASES:
                    _set_path(tree, path, 0.3 * rng.standard_normal(
                        _get_path(tree, path).shape).astype(np.float32))
            if jc.family == "vlm":
                for name, vals in VLM_GATES.items():
                    tree["cross_layers"][name] = np.asarray(vals, np.float32)
            batch = _inputs(jc)
            jb = jax.tree.map(jnp.asarray, batch)
            fwd = _fwd_batch(jb)

            def loss_fn(p):
                return cross_entropy(jm.forward(p, fwd), jb["labels"])
            jparams = jax.tree.map(jnp.asarray, tree)
            logits = jax.jit(jm.forward)(jparams, fwd)
            with pytest.MonkeyPatch.context() as mp:
                if jc.family in ("ssm", "hybrid"):
                    mp.setattr(jmamba2, "jnp", _ClampedExp())
                    # a new function: jit's cache holds the unclamped trace
                    clamped = jax.jit(lambda p, b: jm.forward(p, b))
                    np.testing.assert_allclose(
                        np.asarray(clamped(jparams, fwd)),
                        np.asarray(logits), rtol=1e-6, atol=1e-6)
                loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
            cache[case] = (tc, tree, batch, np.asarray(logits),
                           float(loss), jax.tree.map(np.asarray, grads))
        return cache[case]
    return get


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_logits_match_jax(reference, case):
    tc, tree, batch, logits, _, _ = reference(case)
    tm = tget_model(tc)
    with torch.no_grad():
        got = tm.forward(params_from_numpy(tc, tree, "cpu"),
                         _tbatch(_fwd_batch(batch)))
    assert got.shape == logits.shape
    np.testing.assert_allclose(got.numpy(), logits, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_value_and_grad_match_jax(reference, case):
    tc, tree, batch, _, loss, grads = reference(case)
    step = make_train_step(tget_model(tc), AdamWConfig())
    got_loss, got = step.value_and_grad(_torch_tree(tree), _tbatch(batch))
    assert float(got_loss) == pytest.approx(loss, rel=TOL, abs=TOL)
    want = dict(_leaves(grads))
    have = dict(_leaves(got))
    assert have.keys() == want.keys()
    for path, g in want.items():
        h = have[path].numpy()
        assert h.shape == g.shape, path
        scale = float(np.abs(g).max())
        assert scale > 0 or path.startswith("/tok/"), path
        np.testing.assert_allclose(h, g, rtol=0, atol=TOL * max(scale, 1e-6),
                                   err_msg=path)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))
