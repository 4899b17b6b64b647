"""The port's functional PTT ops (``repro_torch.core.tracetable``: torch
tensors) against the reference's jnp ops on one seeded sequence of
updates and searches: the tables bit-identical after every update, and
every ``(leader, width_idx)`` / ``width_idx`` identical, ties included
(both take the first minimum).  Float32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tracetable as JT
from repro_torch.core import (make_ptt_array, ptt_global_search,
                              ptt_local_search, ptt_update)
from repro_torch.core import ptt as tptt
from repro_torch.core.tracetable import _valid_mask

WIDTHS = (1, 2, 4, 8)


def test_reexported_from_ptt_and_core():
    assert tptt.ptt_update is ptt_update
    assert tptt.ptt_global_search is ptt_global_search
    assert tptt.ptt_local_search is ptt_local_search
    assert tptt.make_ptt_array is make_ptt_array


def test_make_ptt_array_shape_and_dtype():
    t = make_ptt_array(3, 8, WIDTHS)
    j = JT.make_ptt_array(3, 8, WIDTHS)
    assert tuple(t.shape) == j.shape == (3, 8, 4)
    assert t.dtype == torch.float32 and j.dtype == jnp.float32
    assert not t.any()


def test_valid_mask_matches():
    for cores in (1, 4, 8, 12):
        np.testing.assert_array_equal(
            _valid_mask(cores, WIDTHS).numpy(),
            np.asarray(JT._valid_mask(cores, WIDTHS)))


def _bits(t):
    return np.asarray(t).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_sequence_bit_identical(seed):
    """Updates at valid (leader, width) pairs with samples drawn from a
    few repeated values (so ties occur), a global search and a local
    search from every core after each update."""
    rng = np.random.default_rng(seed)
    T, C = 3, 8
    jt = JT.make_ptt_array(T, C, WIDTHS)
    tt = make_ptt_array(T, C, WIDTHS)
    ties = 0
    for step in range(60):
        k = int(rng.integers(0, T))
        wi = int(rng.integers(0, len(WIDTHS)))
        w = WIDTHS[wi]
        leader = int(rng.integers(0, C // w)) * w
        elapsed = float(rng.choice([0.125, 0.25, 0.5, 1.0, 0.3,
                                    rng.uniform(0.01, 2.0)]))
        jt = JT.ptt_update(jt, k, leader, wi, elapsed)
        tt = ptt_update(tt, k, leader, wi, elapsed)
        np.testing.assert_array_equal(_bits(tt.numpy()), _bits(jt))
        jl, jw = JT.ptt_global_search(jt, k, WIDTHS)
        tl, tw = ptt_global_search(tt, k, WIDTHS)
        assert (int(tl), int(tw)) == (int(jl), int(jw)), step
        cost = np.where(np.asarray(JT._valid_mask(C, WIDTHS)),
                        np.asarray(jt[k]) * np.asarray(WIDTHS), np.inf)
        ties += int((cost == cost.min()).sum() > 1)
        for core in range(C):
            assert int(ptt_local_search(tt, k, core, WIDTHS)) == \
                int(JT.ptt_local_search(jt, k, core, WIDTHS)), (step, core)
    assert ties > 0                      # the first-minimum rule was tested


def test_update_is_functional():
    t = make_ptt_array(1, 4, WIDTHS[:3])
    u = ptt_update(t, 0, 0, 1, 0.5)
    assert not t.any() and float(u[0, 0, 1]) == 0.5
    v = ptt_update(u, 0, 0, 1, 1.0)       # (4 * 0.5 + 1.0) / 5
    assert float(v[0, 0, 1]) == np.float32((4.0 * 0.5 + 1.0) / 5.0)
    assert float(u[0, 0, 1]) == 0.5


def test_tensor_indices_and_elapsed():
    """Indices and the sample as 0-d tensors, as a jitted caller passes
    them in the reference."""
    jt = JT.ptt_update(JT.make_ptt_array(2, 4, (1, 2, 4)), 1, 2, 0, 0.75)
    tt = ptt_update(make_ptt_array(2, 4, (1, 2, 4)), torch.tensor(1),
                    torch.tensor(2), torch.tensor(0), torch.tensor(0.75))
    np.testing.assert_array_equal(_bits(tt.numpy()), _bits(jt))
    assert int(ptt_local_search(tt, 1, torch.tensor(3), (1, 2, 4))) == \
        int(JT.ptt_local_search(jt, 1, 3, (1, 2, 4)))
