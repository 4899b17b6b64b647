"""The serving cells (``repro_torch.models.graphs``) under a ``tp`` layout,
on gloo ranks (bodies in ``tests/_torch_layout_ranks.py``), reduced
qwen2-0.5b, float32:

* two ranks on a (data 1, model 2) mesh, each on its blocks of the weights
  and of the cache: under the gloo layout, which cannot be captured
  (``Layout.capturable`` false), ``prefill_chunk``, ``decode_fused`` and
  ``decode_step`` build no cell and give the eager bodies' logits and
  tokens bit for bit; with ``capturable`` patched true, each builds one
  cell under the layout, keyed by its identity, with the same logits and
  tokens;
* the launcher's train step (``DonatedStep``, a ``TrainGraph`` cell) on
  the same two ranks with two microbatches and ``compress_dcn``: under
  the gloo layout no cell and its eager body in place, patched one cell
  keyed by the layout, both bitwise the functional ``TrainStep`` under
  rules over two steps;
* one rank on a (data 1, model 1) mesh, where the cache and the params
  have the same shapes with and without rules, ``capturable`` patched
  true: the same cache and params build one cell of each entry without
  rules and another under them, and later calls find their own.

On the CPU a cell runs its body eagerly over its static buffers, so the
patched cases check the keying and the buffers, not a capture; a capture
under an NCCL layout is ``chip_smoke.py``'s mesh phase.
"""

import numpy as np

import _torch_layout_ranks as ranks
from repro_torch.distributed.ranks import run_ranks

ENTRIES = ("chunk", "fused", "step")


def test_gloo_layout_builds_no_cell_and_patched_cells_match():
    outs = run_ranks(ranks.sharded_body, 2, 0, device="cpu", timeout=240)
    for rank, out in enumerate(outs):
        assert out["capturable"] is False, rank
        assert out["built_gloo"] == dict.fromkeys(ENTRIES, 0), rank
        assert out["built_patched"] == dict.fromkeys(ENTRIES, 1), rank
        assert out["keyed_by_layout"], rank
        for name in ENTRIES:
            want = out["want"][name]
            assert np.isfinite(want).all()
            np.testing.assert_array_equal(out["gloo"][name], want,
                                          err_msg=f"rank {rank} {name}")
            np.testing.assert_array_equal(out["patched"][name], want,
                                          err_msg=f"rank {rank} {name}")
    # both ranks hold the whole logits and the same tokens
    for name in ENTRIES:
        np.testing.assert_array_equal(outs[0]["want"][name],
                                      outs[1]["want"][name])


def test_train_step_under_a_gloo_layout_runs_eagerly_in_place():
    outs = run_ranks(ranks.train_body, 2, 0, device="cpu", timeout=240)
    for rank, out in enumerate(outs):
        assert out["capturable"] is False, rank
        assert (out["built_gloo"], out["built_patched"]) == (0, 1), rank
        assert out["keyed_by_layout"], rank
        assert out["equal_gloo"] and out["equal_patched"], rank
        assert np.isfinite(out["loss"]), rank
    assert outs[0]["loss"] == outs[1]["loss"]       # the mesh's loss


def test_cells_under_rules_are_keyed_apart_from_those_without():
    out, = run_ranks(ranks.one_rank_body, 1, 0, device="cpu", timeout=240)
    ones, zeros = dict.fromkeys(ENTRIES, 1), dict.fromkeys(ENTRIES, 0)
    assert out["built"] == [ones, ones, zeros, zeros]
    assert out["live"] == dict.fromkeys(ENTRIES, 2)
