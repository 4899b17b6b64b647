"""Operations and bytes of a decode step, a prefill chunk and a train
step, by hand, at qwen2-0.5b's published widths."""

import pytest

from portbench.counts import kernels, model, peaks
from portbench.lib import model as M

D = M.dims(M.load_config("qwen2-0.5b"))
G = M.dims(M.load_config("granite-moe-1b-a400m"))


def test_layer_weights_by_hand():
    # q, k, v: 896 x (14 + 2 + 2) x 64; o: 896 x 896; SwiGLU 3 x 896 x 4864
    assert model.layer_matrix_weights(D) == (
        896 * 18 * 64 + 896 * 896 + 3 * 896 * 4864)
    # granite: q, k, v 1024 x (16 + 8 + 8) x 64, o 1024 x 1024, router
    # 1024 x 32, 8 experts of 3 x 1024 x 512
    assert model.layer_matrix_weights(G) == (
        1024 * 32 * 64 + 1024 * 1024 + 1024 * 32 + 8 * 3 * 1024 * 512)


def test_decode_flops_by_hand():
    w = model.layer_matrix_weights(D)
    # one slot at decode position 9: 10 keys, then 11
    one = 24 * (2 * w + 4 * 14 * 64 * 10) + 2 * 896 * 151936
    two = 24 * (2 * w + 4 * 14 * 64 * 11) + 2 * 896 * 151936
    assert model.decode_flops(D, [(9, 2)]) == pytest.approx(one + two)
    assert model.decode_flops(D, [(9, 0)]) == 0


def test_chunk_flops_by_hand():
    w = model.layer_matrix_weights(D)
    # 512 tokens from position 1024: each sees 1025..1536 keys
    pairs = sum(1024 + i + 1 for i in range(512))
    assert model.causal_pairs(1024, 512) == pairs
    assert model.prefill_flops(D, 1024, 512) == pytest.approx(
        24 * (2 * w * 512 + 4 * 14 * 64 * pairs) + 2 * 896 * 151936)


def test_train_flops_by_hand():
    n_mm = 24 * model.layer_matrix_weights(D) + 151936 * 896
    attn = 24 * 12 * 8 * 14 * 64 * (1024 * 1025 // 2)
    assert model.train_flops(D, 8, 1024) == pytest.approx(
        6 * n_mm * 8192 + attn)
    # 3.1 GFLOP a token: the MFU's numerator of PR 32's 46 k tokens/s
    assert model.train_flops(D, 8, 1024) / 8192 == pytest.approx(
        3.1e9, rel=0.02)


def test_ragged_decode_bound_by_hand():
    # 64 slots reading 100,000 rows: q 64 x 14 x 64 bf16, K and V rows
    # 2 x 64 bf16 each, positions, float32 output
    nbytes = (64 * 14 * 64 * 2 + 2 * 100_000 * 2 * 64 * 2 + 64 * 4
              + 64 * 14 * 64 * 4)
    assert kernels.ragged_decode_s(D, 100_000, 64) == pytest.approx(
        nbytes / peaks.HBM_BYTES)        # bytes bind: 3.6 ops a byte


def test_ragged_prefill_bound_by_hand():
    pairs = model.causal_pairs(1536, 512)
    flops = 4 * 14 * 64 * pairs
    nbytes = 512 * 14 * 64 * 2 + 2 * 2048 * 2 * 64 * 2 + 8 + 512 * 14 * 64 * 4
    assert kernels.ragged_prefill_s(D, 1536, 512, 512) == pytest.approx(
        max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES))


def test_flash_bounds_by_hand():
    pairs = 1024 * 1025 // 2
    fwd = 4 * 8 * 14 * 64 * pairs
    bwd = 10 * 8 * 14 * 64 * pairs
    assert kernels.flash_forward_s(D, 8, 1024) == pytest.approx(
        fwd / peaks.BF16_FLOPS)
    assert kernels.flash_backward_s(D, 8, 1024) == pytest.approx(
        bwd / peaks.BF16_FLOPS)
    # PR 24's figures: 0.01521 and 0.03804 ms
    assert kernels.flash_forward_s(D, 8, 1024) * 1e3 == pytest.approx(
        0.01521, rel=0.01)
    assert kernels.flash_backward_s(D, 8, 1024) * 1e3 == pytest.approx(
        0.03804, rel=0.01)


def test_param_counts_of_the_configs():
    assert M.n_params(D) == pytest.approx(494e6, rel=0.01)
    assert M.n_params(G) == pytest.approx(1.385e9, rel=0.01)
