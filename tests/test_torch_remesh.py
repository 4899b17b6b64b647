"""The port's ``elastic_remesh`` (``repro_torch.distributed.elastic``) on
gloo ranks, the counterpart of ``tests/test_elastic.py``'s elastic
restart:

* smollm-135m reduced from the reference's initial state: 8 ranks hold
  the training state replicated and train 5 steps, all 8 create the mesh
  of ranks 0-3, ranks 4-7 leave, the survivors re-mesh the state and
  train 5 more steps on the deterministic data pipeline.  The final
  parameters equal the port's uninterrupted 10 steps within rtol 2e-4,
  atol 2e-5 (they are bitwise equal where the CPU's matrix products are
  repeatable) and the reference's uninterrupted run within 2e-4 abs and
  rel, the port's training parity tolerance
  (``tests/test_torch_train.py``): the two packages sum in different
  orders and AdamW divides by ``sqrt(v)``;
* a parameter tree placed by ``logical_sharding`` on (data 2, model 4)
  and re-meshed onto (data 1, model 4) keeps every leaf's
  ``full_tensor()`` bit for bit, ranks outside the new mesh hold empty
  shards, and ``constrain`` redistributes a replicated DTensor to its
  spec's placements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from repro.configs import get_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMData as JData
from repro.models import get_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import make_train_step as jmake_train_step
from repro.train import train_state_init as jtrain_state_init
from repro_torch.configs import get_config as tget_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.distributed.ranks import run_ranks
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves

STEPS = 5


@pytest.fixture(scope="module")
def reference():
    """The reference's initial state and its uninterrupted 10 steps."""
    cfg = get_config(ranks.ELASTIC_ARCH, reduced=True)
    m = get_model(cfg)
    opt = JAdamWConfig(**ranks.ELASTIC_OPT)
    state, _ = jtrain_state_init(m, jax.random.PRNGKey(0), opt)
    start = jax.tree.map(np.asarray, state)
    step = jax.jit(jmake_train_step(m, opt))
    src = JData(JDataConfig(vocab=cfg.vocab, **ranks.ELASTIC_DATA))
    try:
        for i in range(2 * STEPS):
            state, _ = step(state, {k: jnp.asarray(v)
                                    for k, v in src.batch_at(i).items()})
    finally:
        src.close()
    return start, jax.tree.map(np.asarray, state["params"])


def _port_uninterrupted(start):
    model = tget_model(tget_config(ranks.ELASTIC_ARCH, reduced=True))
    step = make_train_step(model, AdamWConfig(**ranks.ELASTIC_OPT))
    data = SyntheticLMData(DataConfig(vocab=model.cfg.vocab,
                                      **ranks.ELASTIC_DATA))
    try:
        state = ranks.elastic_steps(step, data,
                                    train_state_from_numpy(start, "cpu"),
                                    0, 2 * STEPS)
    finally:
        data.close()
    return train_state_to_numpy(state["params"])


def test_elastic_remesh_training_continues(reference):
    start, jax_final = reference
    outs = run_ranks(ranks.elastic_train_body, 8, start, STEPS,
                     device="cpu", timeout=60.0)
    assert outs[1:] == [None] * 7
    elastic = tree_leaves(outs[0])
    straight = tree_leaves(_port_uninterrupted(start))
    want = jax.tree.leaves(jax_final)
    assert len(elastic) == len(straight) == len(want)
    for e, s, w in zip(elastic, straight, want):
        np.testing.assert_allclose(e, s, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(e, w, rtol=2e-4, atol=2e-4)


def test_logical_sharding_remesh_keeps_full_tensors(reference):
    params = reference[0]["params"]
    outs = run_ranks(ranks.logical_remesh_body, 8, params, device="cpu",
                     timeout=60.0)
    for rank, out in enumerate(outs):
        # the tied embedding (vocab, d_model): vocab over model, d_model
        # over data (fsdp)
        assert out["placements_a"] == ["(Shard(dim=1), Shard(dim=0))"]
        if rank < 4:
            assert out["equal"], rank
            assert out["placements_b"] == ["(Shard(dim=1), Shard(dim=0))"]
        else:
            assert out["empty"], rank
        assert out["constrain"] == ("(Shard(dim=0), Shard(dim=1))",
                                    (4, 4), True)
