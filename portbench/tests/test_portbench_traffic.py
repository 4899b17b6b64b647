"""The traffic generator: the same seed gives the same requests, and every
seed the same multiset of sizes and gaps (only their order and the token
ids change)."""

import numpy as np
import pytest

from portbench.lib import model as M
from portbench.lib import traffic

CHAT = {"prompt": {"dist": "lognormal", "median": 512, "sigma": 0.8,
                   "min": 32, "max": 3072},
        "output": {"dist": "lognormal", "median": 192, "sigma": 0.8,
                   "min": 16, "max": 1024}}


def _reqs(seed, stream=3, n=200):
    return traffic.requests(CHAT, n, traffic.rng(seed, stream), 151936, 4096)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 12345, 2**40 + 3])
def test_same_seed_same_requests(seed):
    a, b = _reqs(seed), _reqs(seed)
    assert len(a) == len(b) == 200
    for (pa, ma), (pb, mb) in zip(a, b):
        assert ma == mb and np.array_equal(pa, pb)
    ta = traffic.arrivals(traffic.rng(seed, 4), 50, 10.0)
    tb = traffic.arrivals(traffic.rng(seed, 4), 50, 10.0)
    assert np.array_equal(ta, tb)


def test_seeds_share_sizes_not_order():
    a, b = _reqs(1), _reqs(2)
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    ga = np.diff(traffic.arrivals(traffic.rng(1, 4), 50, 10.0))
    gb = np.diff(traffic.arrivals(traffic.rng(2, 4), 50, 10.0))
    # 49 of the same 50 gaps each (the last one closes the window)
    shared = np.intersect1d(np.round(ga, 9), np.round(gb, 9))
    assert len(shared) >= 48
    assert not np.allclose(ga, gb)


def test_streams_differ():
    a, b = _reqs(5, stream=1), _reqs(5, stream=3)
    assert any(not np.array_equal(pa, pb) for (pa, _), (pb, _) in zip(a, b))


def test_sizes_are_stratified_quantiles():
    s = traffic.sizes({"dist": "uniform", "min": 1024, "max": 3072}, 4)
    assert s.tolist() == [1280, 1792, 2304, 2816]
    s = traffic.sizes(CHAT["prompt"], 101)
    assert s[50] == 512 and s.min() >= 32 and s.max() <= 3072
    assert np.all(np.diff(s) >= 0)


def test_arrivals_fill_the_window():
    t = traffic.arrivals(traffic.rng(3, 4), 160, 10.0)
    assert t[0] == 0.0 and np.all(np.diff(t) > 0) and t[-1] < 10.0
    assert t[-1] > 9.0


def test_requests_never_reach_the_cache_edge():
    for prompt, max_new in _reqs(9, n=500):
        assert 1 <= max_new and len(prompt) + max_new <= 4095
        assert prompt.dtype == np.int64
        assert 0 <= prompt.min() and prompt.max() < 151936


def test_weights_same_seed_same_values():
    d = M.Dims(family="dense", L=2, D=64, Hq=2, Hkv=1, hd=32, F=96, V=50,
               tied=True, qkv_bias=True, theta=1e6, eps=1e-6)
    a, b = M.make_weights(d, 11, "cpu"), M.make_weights(d, 11, "cpu")
    c = M.make_weights(d, 12, "cpu")
    for (pa, ta), (_, tb), (_, tc) in zip(*(
            sorted(_leaves(t)) for t in (a, b, c))):
        assert ta.equal(tb) and not ta.equal(tc), pa
    assert M.n_params(d) == sum(t.numel() for _, t in _leaves(a))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_every_block_of_a_pool_holds_the_same_sizes():
    spec = CHAT["output"]
    for seed in (1, 2):
        got = traffic.lengths(spec, 200, traffic.rng(seed, 3), block=64)
        assert len(got) == 200
        for lo in range(0, 192, 64):
            assert sorted(got[lo:lo + 64]) == sorted(traffic.sizes(spec, 64))
    a = traffic.lengths(spec, 200, traffic.rng(1, 3), block=64)
    assert not np.array_equal(a, traffic.lengths(spec, 200,
                                                 traffic.rng(2, 3), block=64))
