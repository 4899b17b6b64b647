"""The launcher's train step as a cell (``repro_torch.train.step.
DonatedStep`` over ``repro_torch.models.graphs.TrainGraph``) on the CPU,
reduced smollm-135m, the reference's initial state carried over, held
against the JAX trainer and against the port's eager, functional
``TrainStep``:

* ten donated steps give the JAX trainer's losses and its states at steps
  3, 6 and 10 (``tests/test_torch_train.py``'s tolerances: losses 1e-4,
  states 2e-4, abs and rel);
* ten donated steps are bitwise the eager ``TrainStep``'s (losses, gradient
  norms, learning rates, every leaf of the state), plain, with two
  microbatches and with ``compress_dcn``; ``adamw_update_`` and
  ``ef_compress_grads_`` bitwise their functional forms;
* donation: the state returned is the dict given, every leaf at its
  address;
* cells: one after ten steps; a second batch shape builds a second; a
  state with new tensors (a resume) a third, and the old cell leaves
  ``live()`` once its state is collected; under a cost counter the step
  runs ``cell.eager`` and builds none;
* an ``AsyncCheckpointer.save`` followed by a further step writes the
  saved step's state.

On the CPU a cell captures nothing and runs its body eagerly over its
static buffers; the graph itself is ``chip_smoke.py``'s train phase.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JData
from repro.models import get_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import train_state_init as jtrain_state_init
from repro_torch.checkpoint import AsyncCheckpointer, load_checkpoint
from repro_torch.configs import get_config as tget_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed.cost import CostCounter
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.train import DonatedStep, make_train_step
from repro_torch.tree import tree_items, tree_map

ARCH = "smollm-135m"
OPT = dict(lr=5e-3, warmup_steps=3, total_steps=50)
DATA = dict(global_batch=8, seq_len=32, seed=1)
STEPS = 10
TOL = 1e-4
PARAM_TOL = 2e-4
OPTIONS = {"plain": {}, "microbatches": {"microbatches": 2},
           "compress_dcn": {"compress_dcn": True}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trajectory():
    """The JAX trainer's run: numpy states at steps 0, 3, 6 and 10 and the
    10 losses; the port's model, AdamW config and data."""
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
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, **DATA))
    yield dict(states=states, losses=losses,
               model=tget_model(tget_config(ARCH, reduced=True)),
               opt=tadamw.AdamWConfig(**OPT), data=data)
    data.close()


def _batch(tr, step, rows=None):
    return {k: torch.from_numpy(v[:rows])
            for k, v in tr["data"].batch_at(step).items()}


def _start(tr, **options):
    state = train_state_from_numpy(tr["states"][0], "cpu")
    if options.get("compress_dcn"):
        state["ef"] = tcomp.ef_init(state["params"])
    return state


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _equal(got, want):
    g, w = dict(tree_items(got)), dict(tree_items(want))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert torch.equal(g[path], w[path]), path


def test_donated_steps_match_jax(trajectory):
    tr = trajectory
    step = DonatedStep(make_train_step(tr["model"], tr["opt"]))
    state, losses = _start(tr), []
    for i in range(STEPS):
        state, metrics = step(state, _batch(tr, i))
        losses.append(float(metrics["loss"]))
        if i + 1 in (3, 6, STEPS):
            want = dict(tree_items(tr["states"][i + 1]))
            for path, t in tree_items(state):
                np.testing.assert_allclose(_np(t), want[path], rtol=PARAM_TOL,
                                           atol=PARAM_TOL,
                                           err_msg=f"step {i + 1} {path}")
    np.testing.assert_allclose(losses, tr["losses"], rtol=TOL, atol=TOL)
    assert losses[-1] < losses[0]
    assert step.cell.cells() == 1


@pytest.mark.parametrize("options", list(OPTIONS.values()),
                         ids=list(OPTIONS))
def test_donated_steps_bitwise_the_eager_step(trajectory, options):
    tr = trajectory
    eager = make_train_step(tr["model"], tr["opt"], **options)
    donated = DonatedStep(make_train_step(tr["model"], tr["opt"], **options))
    want, state = _start(tr, **options), _start(tr, **options)
    for i in range(STEPS):
        batch = _batch(tr, i)
        want, wm = eager(want, batch)
        state, m = donated(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m[k], wm[k]), (i, k)
    _equal(state, want)
    assert donated.cell.cells() == 1


@pytest.mark.parametrize("clipped", [False, True],
                         ids=["unclipped", "clipped"])
def test_in_place_updates_bitwise_the_functional_ones(clipped):
    rng = np.random.default_rng(3)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    params = {"layers": {"w": n(3, 4, 5), "scale": n(3, 5)},
              "ln_f": {"scale": n(5)}, "gate": n()}
    grads = tree_map(lambda p: n(*p.shape) * (100.0 if clipped else 0.01),
                     params)
    state = {"m": tree_map(lambda p: 0.1 * n(*p.shape), params),
             "v": tree_map(lambda p: 0.01 * n(*p.shape).abs(), params),
             "step": torch.tensor(7, dtype=torch.int32)}
    resid = tree_map(lambda p: 0.01 * n(*p.shape), params)
    cfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    want_g, want_r = tcomp.ef_compress_grads(grads, resid)
    got_g = tcomp.ef_compress_grads_(grads, resid)
    _equal(got_g, want_g)
    _equal(resid, want_r)
    want_p, want_s, want_m = tadamw.adamw_update(cfg, got_g, state, params)
    got_m = tadamw.adamw_update_(cfg, got_g, state, params)
    _equal(params, want_p)
    _equal(state, want_s)
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])
    assert torch.equal(got_m["lr"], want_m["lr"])
    assert (float(got_m["grad_norm"]) > 1.0) == clipped


def test_state_is_donated(trajectory):
    tr = trajectory
    step = DonatedStep(make_train_step(tr["model"], tr["opt"]))
    state = _start(tr)
    ptrs = [(p, t.data_ptr()) for p, t in tree_items(state)]
    for i in range(3):
        got, _ = step(state, _batch(tr, i))
        assert got is state
        assert [(p, t.data_ptr()) for p, t in tree_items(got)] == ptrs
    assert int(state["opt"]["step"]) == 3


def test_cells_by_batch_shape_and_state(trajectory):
    tr = trajectory
    step = DonatedStep(make_train_step(tr["model"], tr["opt"]))
    cell = step.cell
    state = _start(tr)
    for i in range(STEPS):
        state, _ = step(state, _batch(tr, i))
    assert (cell.cells(), cell.live()) == (1, 1)
    state, _ = step(state, _batch(tr, STEPS, rows=4))     # another shape
    state, _ = step(state, _batch(tr, STEPS + 1, rows=4))
    state, _ = step(state, _batch(tr, STEPS + 2))
    assert (cell.cells(), cell.live()) == (2, 2)
    resumed = tree_map(lambda t: t.clone(), state)          # new tensors
    resumed, _ = step(resumed, _batch(tr, STEPS + 3))
    assert (cell.cells(), cell.live()) == (3, 3)
    del state
    gc.collect()
    assert (cell.cells(), cell.live()) == (3, 1)
    assert cell.capture_ms == [None] * 3                    # the CPU's


def test_cost_counter_runs_the_eager_body(trajectory):
    tr = trajectory
    step = DonatedStep(make_train_step(tr["model"], tr["opt"]))
    eager = make_train_step(tr["model"], tr["opt"])
    state, batch = _start(tr), _batch(tr, 0)
    want, wm = eager(_start(tr), batch)
    with CostCounter() as c:
        got, m = step(state, batch)
    assert step.cell.cells() == 0 and step.cell.live() == 0
    assert c.totals.flops > 0
    assert got is state and torch.equal(m["loss"], wm["loss"])
    _equal(got, want)


def test_checkpoint_save_then_a_step_keeps_the_saved_state(trajectory,
                                                           tmp_path):
    tr = trajectory
    step = DonatedStep(make_train_step(tr["model"], tr["opt"]))
    state = _start(tr)
    for i in range(2):
        state, _ = step(state, _batch(tr, i))
    saved = tree_map(lambda t: t.clone(), state)
    ckpt = AsyncCheckpointer(str(tmp_path))
    ckpt.save(2, state, extra={"data": {"step": 2}})
    state, _ = step(state, _batch(tr, 2))               # in place, at once
    ckpt.wait()
    assert not torch.equal(state["opt"]["step"], saved["opt"]["step"])
    back, extra = load_checkpoint(str(tmp_path), 2, state, device="cpu")
    assert extra == {"data": {"step": 2}}
    _equal(back, saved)
