"""The port's training path on the CPU (``repro_torch.data``, ``optim``,
``train`` and ``launch.train``), held against the JAX package: the
counterparts of ``tests/test_data.py``, ``tests/test_optim.py`` and
``tests/test_integration_train.py``.

* the synthetic batches are bit-identical to the JAX pipeline's;
* ``cosine_lr``'s endpoints, clipping by the global norm, weight decay on
  matrices only and the whole AdamW update against the JAX functions;
* ``ef_compress_grads`` gives the JAX package's int8 payload;
* ten ``smollm-135m`` reduced steps from the JAX initial state on the same
  batches give the JAX trainer's losses and parameters;
* four microbatches match the full batch; 10 steps + a checkpoint + 10
  equal 20 straight steps bit for bit; a JAX training checkpoint written
  after 3 steps resumes in the port and matches the JAX run's 6-step
  state; the launcher learns, and resumes from its own checkpoint bit for
  bit.

One JAX trajectory (10 steps) is shared by the module.  Tolerances
(float32 on both sides; sums run in different orders, and AdamW divides
by ``sqrt(v)``, which makes small gradient differences relative):
losses 1e-4 abs and rel for 10 steps, parameters after 6 or 10 steps
2e-4 abs and rel, one AdamW update 1e-6 (1e-5 on the learning-rate
schedule's cosine), the int8 payload exact.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jsave
from repro.configs import get_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JData
from repro.models import get_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import make_train_step as jmake_train_step
from repro.train import train_state_init as jtrain_state_init
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config as tget_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.launch import train as tlaunch
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.train import make_eval_step, make_train_step

ARCH = "smollm-135m"
OPT = dict(lr=5e-3, warmup_steps=3, total_steps=50)
DATA = dict(global_batch=8, seq_len=32, seed=1)
STEPS = 10
TOL = 1e-4
PARAM_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path in w:
        np.testing.assert_allclose(_np(g[path]), _np(w[path]), rtol=tol,
                                   atol=tol, err_msg=path)


def _equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path in w:
        assert _np(g[path]).dtype == _np(w[path]).dtype, path
        np.testing.assert_array_equal(_np(g[path]), _np(w[path]),
                                      err_msg=path)


def _batch(data, step):
    return {k: torch.from_numpy(v) for k, v in data.batch_at(step).items()}


@pytest.fixture(scope="module")
def trajectory():
    """The JAX trainer's run: numpy states at steps 0, 3, 6 and 10 and
    the 10 losses; the port's model, step, data and AdamW config."""
    cfg = get_config(ARCH, reduced=True)
    jm = get_model(cfg)
    jopt = JAdamWConfig(**OPT)
    state, _ = jtrain_state_init(jm, jax.random.PRNGKey(0), jopt)
    step = jax.jit(jmake_train_step(jm, jopt))
    jdata = JData(JDataConfig(vocab=cfg.vocab, **DATA))
    states, losses = {0: jax.tree.map(np.asarray, state)}, []
    for i in range(STEPS):
        b = {k: jnp.asarray(v) for k, v in jdata.batch_at(i).items()}
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        if i + 1 in (3, 6, STEPS):
            states[i + 1] = jax.tree.map(np.asarray, state)
    jdata.close()
    tm = tget_model(tget_config(ARCH, reduced=True))
    topt = tadamw.AdamWConfig(**OPT)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, **DATA))
    yield dict(states=states, losses=losses, model=tm, opt=topt, data=data)
    data.close()


def _port_run(tr, state, lo, hi, step=None):
    step = step or make_train_step(tr["model"], tr["opt"])
    losses = []
    for i in range(lo, hi):
        state, metrics = step(state, _batch(tr["data"], i))
        losses.append(float(metrics["loss"]))
    return state, losses


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_batches_bit_identical(shards):
    for shard in range(shards):
        kw = dict(vocab=151936, global_batch=4, seq_len=64, seed=7,
                  n_shards=shards, shard=shard)
        jd, td = JData(JDataConfig(**kw)), SyntheticLMData(DataConfig(**kw))
        try:
            for step in (0, 5, 123):
                jb, tb = jd.batch_at(step), td.batch_at(step)
                assert jb.keys() == tb.keys()
                for k in jb:
                    assert jb[k].dtype == tb[k].dtype
                    np.testing.assert_array_equal(jb[k], tb[k])
            for _ in range(3):                 # the prefetching iterator
                jb, tb = next(jd), next(td)
                np.testing.assert_array_equal(jb["tokens"], tb["tokens"])
            assert jd.state() == td.state()
        finally:
            jd.close()
            td.close()


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------

def test_cosine_lr_endpoints():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    tc, jc = tadamw.AdamWConfig(**kw), JAdamWConfig(**kw)
    assert float(tadamw.cosine_lr(tc, 0)) == 0.0
    assert float(tadamw.cosine_lr(tc, 10)) == pytest.approx(1e-3, rel=1e-6)
    assert float(tadamw.cosine_lr(tc, 110)) == pytest.approx(1e-4, rel=1e-5)
    assert float(tadamw.cosine_lr(tc, 500)) == pytest.approx(1e-4, rel=1e-5)
    for s in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 111, 500):
        assert float(tadamw.cosine_lr(tc, s)) == pytest.approx(
            float(jadamw.cosine_lr(jc, s)), rel=1e-5, abs=1e-12), s


def _tree(rng, scale=1.0):
    """A parameter-like tree: a stacked matrix, a stacked vector (decays:
    ndim 2), a bare vector (does not) and a scalar."""
    n = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"layers": {"w": n(3, 4, 5), "scale": n(3, 5)},
            "ln_f": {"scale": n(5)}, "gate": n()}


def _opt_state(rng, params, step):
    m = jax.tree.map(lambda p: 0.1 * rng.standard_normal(
        np.shape(p)).astype(np.float32), params)
    v = jax.tree.map(lambda p: np.abs(0.01 * rng.standard_normal(
        np.shape(p))).astype(np.float32), params)
    return {"m": m, "v": v, "step": np.asarray(step, np.int32)}


@pytest.mark.parametrize("grad_scale", [0.01, 100.0], ids=["unclipped",
                                                            "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    state = _opt_state(rng, params, 7)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=1.0)
    jp, js, jm = jadamw.adamw_update(
        JAdamWConfig(**kw), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, params))
    t = lambda tree: train_state_from_numpy(tree, "cpu")
    tp, ts, tm = tadamw.adamw_update(tadamw.AdamWConfig(**kw), t(grads),
                                     t(state), t(params))
    gnorm = float(tm["grad_norm"])
    assert gnorm == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert (gnorm > 1.0) == (grad_scale > 1.0)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(ts["step"]) == 8 and ts["step"].dtype == torch.int32
    _close(tp, jp, 1e-6)
    _close({"m": ts["m"], "v": ts["v"]}, {"m": js["m"], "v": js["v"]}, 1e-6)


def test_decay_only_on_matrices():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    zeros = jax.tree.map(np.zeros_like, params)
    state = {"m": zeros, "v": zeros, "step": np.asarray(10, np.int32)}
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=100,
                             weight_decay=0.5)
    t = lambda tree: train_state_from_numpy(tree, "cpu")
    new, _, m = tadamw.adamw_update(cfg, t(zeros), t(state), t(params))
    lr = float(m["lr"])
    for path, p in _leaves(params):
        got = _np(dict(_leaves(new))[path])
        if np.ndim(p) >= 2:
            np.testing.assert_allclose(got, p - lr * 0.5 * p, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, p)


def test_ef_compress_same_int8_payload():
    rng = np.random.default_rng(2)
    grads, resid = _tree(rng), _tree(rng, 0.01)
    x = grads["layers"]["w"] + resid["layers"]["w"]
    jq, js = jcomp._quantize(jnp.asarray(x))
    tq, ts = tcomp.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    jg, jr = jcomp.ef_compress_grads(jax.tree.map(jnp.asarray, grads),
                                     jax.tree.map(jnp.asarray, resid))
    t = lambda tree: train_state_from_numpy(tree, "cpu")
    tg, tr = tcomp.ef_compress_grads(t(grads), t(resid))
    _equal(tg, jax.tree.map(np.asarray, jg))
    _equal(tr, jax.tree.map(np.asarray, jr))


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def test_train_state_round_trip(trajectory):
    tree = trajectory["states"][3]
    state = train_state_from_numpy(tree, "cpu")
    assert state["opt"]["step"].shape == () and \
        state["opt"]["step"].dtype == torch.int32
    _equal(train_state_to_numpy(state), tree)


def test_ten_steps_match_jax(trajectory):
    state = train_state_from_numpy(trajectory["states"][0], "cpu")
    state, losses = _port_run(trajectory, state, 0, STEPS)
    np.testing.assert_allclose(losses, trajectory["losses"], rtol=TOL,
                               atol=TOL)
    assert losses[-1] < losses[0]
    _close(state["params"], trajectory["states"][STEPS]["params"],
           PARAM_TOL)


def test_eval_step_matches_the_train_loss(trajectory):
    state = train_state_from_numpy(trajectory["states"][0], "cpu")
    loss = make_eval_step(trajectory["model"])(state["params"],
                                               _batch(trajectory["data"], 0))
    assert float(loss) == pytest.approx(trajectory["losses"][0], rel=TOL)


def test_microbatched_grads_match_full_batch(trajectory):
    tm, opt = trajectory["model"], trajectory["opt"]
    state = train_state_from_numpy(trajectory["states"][0], "cpu")
    b = _batch(trajectory["data"], 0)
    s1, m1 = make_train_step(tm, opt)(state, b)
    s4, m4 = make_train_step(tm, opt, microbatches=4)(state, b)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    for (_, a), (_, c) in zip(_leaves(s1["params"]), _leaves(s4["params"])):
        np.testing.assert_allclose(_np(a), _np(c), rtol=2e-4, atol=2e-5)


def test_restart_bitwise(trajectory, tmp_path):
    """10 steps + checkpoint + 10 steps == 20 straight steps, bit for bit
    (the fault-tolerance contract)."""
    start = train_state_from_numpy(trajectory["states"][0], "cpu")
    straight, _ = _port_run(trajectory, start, 0, 20)
    half, _ = _port_run(trajectory, start, 0, 10)
    save_checkpoint(str(tmp_path), 10, half, extra={"data": {"step": 10}})
    resumed, extra = load_checkpoint(str(tmp_path), 10, half, device="cpu")
    assert extra["data"]["step"] == 10
    resumed, _ = _port_run(trajectory, resumed, 10, 20)
    _equal(resumed, straight)


def test_jax_checkpoint_resumes_in_port(trajectory, tmp_path):
    """A JAX training checkpoint after 3 steps, loaded by the port's store
    into the port's state and run 3 more steps, matches the JAX run's
    6-step state."""
    jsave(str(tmp_path), 3, jax.tree.map(jnp.asarray,
                                         trajectory["states"][3]),
          extra={"data": {"step": 3}})
    template = train_state_from_numpy(trajectory["states"][0], "cpu")
    state, extra = load_checkpoint(str(tmp_path), 3, template, device="cpu")
    assert extra["data"]["step"] == 3 and int(state["opt"]["step"]) == 3
    state, losses = _port_run(trajectory, state, 3, 6)
    np.testing.assert_allclose(losses, trajectory["losses"][3:6], rtol=TOL,
                               atol=TOL)
    _close(state, trajectory["states"][6], PARAM_TOL)


def _launch(*extra):
    return tlaunch.run(["--device", "cpu", "--arch", ARCH, "--reduced",
                        "--seq-len", "32", "--lr", "5e-3",
                        "--log-every", "1000", *extra])


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compressed"])
def test_launcher_learns(compress):
    out = _launch("--steps", "30", *(["--compress-dcn"] if compress
                                     else []))
    assert len(out["losses"]) == 30 and len(out["step_s"]) == 30
    assert out["losses"][-1] < out["losses"][0] - 1.0
    assert ("ef" in out["state"]) == compress


def test_launcher_resumes_bitwise(tmp_path):
    """A run checkpointed every 3 steps, its last checkpoint deleted and
    resumed from step 3, ends in the straight run's state."""
    straight = _launch("--steps", "6")["state"]
    ck = str(tmp_path)
    _launch("--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3")
    shutil.rmtree(os.path.join(ck, "step_00000006"))
    resumed = _launch("--steps", "6", "--ckpt-dir", ck, "--resume")
    assert resumed["losses"] and len(resumed["losses"]) == 3
    _equal(resumed["state"], straight)
