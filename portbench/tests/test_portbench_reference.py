"""Each plain reference held against the program at the reduced
configurations (64-wide heads) on the CPU, with the same weights from
``lib.model.make_weights``: the dense and MoE prefill, then decode logits
through the cache, and the training step's loss, gradients and updated
parameters.  The yardstick is right before the card uses it."""


import numpy as np
import pytest
import torch

from portbench.lib import model as M
from portbench.reference import dense, moe
from portbench.reference import train as ref_train
from portbench.tests import tiny

TOL = dict(rtol=2e-4, atol=2e-4)      # float32 on both sides; the CPU's
                                     # reduction orders differ


def _program(config):
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy
    cfg, d = tiny.port_and_dims(config)
    tree = M.make_weights(d, 3, "cpu")
    return cfg, d, tree, get_model(cfg), params_from_numpy(cfg, tree, "cpu")


def _port_served_logits(model, params, prompt, served, max_seq=64):
    """Prefill the prompt whole, then decode each served token but the
    last through a ``max_seq`` cache: the logits of every served token."""
    S = prompt.shape[0]
    out, pc = model.prefill(params, {"tokens": prompt[None]})
    rows = [out[0, -1]]
    cache = {n: torch.zeros(shape, dtype=dt)
             for n, (shape, dt) in model.cache_spec(1, max_seq).items()}
    model.insert_session(cache, 0, model.extract_session(pc, 0, S))
    for j, tok in enumerate(served[:-1]):
        lg, cache = model.decode(params, tok.view(1, 1),
                                 torch.tensor([S + j], dtype=torch.int32),
                                 cache)
        rows.append(lg[0, -1])
    return torch.stack(rows)


@pytest.mark.parametrize("config,ref", [("qwen2-0.5b", dense),
                                        ("granite-moe-1b-a400m", moe)])
def test_prefill_then_decode_logits(config, ref):
    cfg, d, tree, model, params = _program(config)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, d.V, (40,), generator=g)
    served = torch.randint(0, d.V, (9,), generator=g)
    with torch.no_grad():
        got = _port_served_logits(model, params, prompt, served)
        want = ref.served_logits(d, tree, prompt, served)
    assert got.shape == want.shape == (9, d.V)
    torch.testing.assert_close(got, want, **TOL)


def test_moe_capacity_drops_copies_as_the_program_does():
    """At a prompt long enough to overfill an expert, the reference drops
    the same copies: without the capacity rule it disagrees."""
    cfg, d, tree, model, params = _program("granite-moe-1b-a400m")
    prompt = torch.randint(0, d.V, (48,), generator=torch.Generator()
                           .manual_seed(8))
    with torch.no_grad():
        got, _ = model.prefill(params, {"tokens": prompt[None]})
        want = moe.served_logits(d, tree, prompt, prompt[:1])[0]
        dropless = dense.served_logits(d, tree, prompt, prompt[:1],
                                       dense.EXACT, moe.ffn)[0]
    torch.testing.assert_close(got[0, -1], want, **TOL)
    assert (got[0, -1] - dropless).abs().max() > 1e-3


def test_train_steps_loss_gradients_and_parameters():
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import make_train_step
    cfg, d = tiny.port_and_dims("qwen2-0.5b")
    hp = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              clip_norm=1.0, warmup_steps=2, total_steps=10, min_lr_frac=0.1)
    step = make_train_step(get_model(cfg), AdamWConfig(**hp))
    params = M.make_weights(d, 4, "cpu")
    state = {"params": params, "opt": adamw_init(params)}
    tree = M.make_weights(d, 4, "cpu")
    mom = {"m": {}, "v": {}}
    g = torch.Generator().manual_seed(1)
    for i in range(2):
        toks = torch.randint(0, d.V, (4, 17), generator=g)
        state, m = step(state, {"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]})
        loss, grads = ref_train.loss_and_grads(d, tree, toks, dense, rows=3)
        ref_train.adamw(hp, tree, grads, mom, i + 1)
        assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    # Adam divides each gradient by its own root mean square, so where a
    # gradient is round-off the two sides' steps differ element by element;
    # the change of each leaf is held by its norm, as on the card
    start = dict(ref_train.leaves(M.make_weights(d, 4, "cpu")))
    want = {p: float((t - start[p]).norm()) for p, t in ref_train.leaves(tree)}
    got = {p: float((t - start[p]).norm())
           for p, t in ref_train.leaves(state["params"])}
    from portbench.drivers.train import leaf_gap
    assert leaf_gap(got, want) < 1e-4
    norms = lambda tree: {p: float(t.norm()) for p, t in
                          ref_train.leaves(tree)}
    assert leaf_gap(norms(state["opt"]["m"]), norms(mom["m"])) < 1e-4


def test_weights_fit_the_programs_tree():
    from repro_torch.models.convert import param_shapes
    for config in ("qwen2-0.5b", "granite-moe-1b-a400m"):
        cfg, d = tiny.port_and_dims(config)
        got = {p: tuple(t.shape) for p, t in
               ref_train.leaves(M.make_weights(d, 0, "cpu"))}
        want = dict(ref_train.leaves(param_shapes(cfg)))
        assert got == {p: tuple(s) for p, s in want.items()}


def test_fp8_control_rounds_the_products():
    x = torch.linspace(-3, 3, 101)
    q = dense.FP8.round(x)
    assert 1e-3 < (q - x).abs().max() <= 3 / 16  # 3 bits below 4
    assert torch.equal(dense.EXACT.mm(x[None], x[:, None]),
                       x[None] @ x[:, None])
    assert not np.isclose(float(dense.FP8.mm(x[None] + 0.01, x[:, None])),
                          float((x[None] + 0.01) @ x[:, None]), rtol=1e-6)
