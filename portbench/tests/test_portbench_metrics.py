"""The metric arithmetic on hand-made records: percentiles over every
request, the TPOT edge cases, the drain's missing first tokens, window
tokens, and the trace's union of intervals and idle gaps."""

import types

import pytest

from portbench.lib import profile, serving, stats


def test_percentile_linear_between_order_statistics():
    vals = list(range(1, 21))                   # 1..20
    assert stats.percentile(vals, 95) == pytest.approx(19.05)
    assert stats.percentile(vals, 50) == pytest.approx(10.5)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 95) is None
    assert serving.p95_ms([0.001 * v for v in vals]) == pytest.approx(19.05)


def test_spread_is_quartile_distance_over_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def _loop(records):
    """A Loop with no engine over hand-made requests."""
    loop = serving.Loop.__new__(serving.Loop)
    loop.live = {}
    for rid, (due, t_first, t_admit, times, in_window) in enumerate(records):
        req = types.SimpleNamespace(rid=rid, t_first=t_first, t_admit=t_admit,
                                    done=True, out_tokens=[0] * sum(
                                        c for _, c in times))
        loop.live[rid] = serving.Live(req=req, n=4, due=due,
                                      in_window=in_window, submitted=due,
                                      times=times)
    return loop


def test_ttft_over_every_window_request_and_the_drain():
    loop = _loop([
        (0.0, 0.10, 0.01, [(0.1, 1)], True),
        (1.0, 1.30, 1.2, [(1.3, 1)], True),
        (2.0, None, None, [], True),           # never got a token
        (-1.0, 5.0, 0.0, [(5.0, 1)], False),   # warm-up: not counted
    ])
    ttft, missing = loop.ttfts()
    assert sorted(ttft) == pytest.approx([0.1, 0.3]) and missing == 1
    assert sorted(loop.queue_waits()) == pytest.approx([0.01, 0.2])


def test_tpot_edge_cases():
    loop = _loop([
        # first token, then three 4-token chunks: 12 tokens after the first
        (0.0, 0.1, 0.0, [(0.1, 1), (0.2, 4), (0.3, 4), (0.4, 4)], True),
        # all its tokens at one step (one record): no gap to time
        (0.0, 0.1, 0.0, [(0.1, 4)], True),
        # one token inside the window only
        (0.0, 0.1, 0.0, [(0.5, 1), (9.0, 4)], True),
        # the window cuts it: tokens at 0.9 (4) and 1.1 (4) inside [0.8, 1.2]
        (0.0, 0.1, 0.0, [(0.7, 4), (0.9, 4), (1.1, 4), (1.5, 4)], True),
    ])
    got = loop.tpots(0.0, 1.2)
    # 1: (0.4 - 0.1) / 12; 2: one time only; 3: one token inside;
    # 4 over [0, 1.2]: (1.1 - 0.7) / 8
    assert sorted(got) == pytest.approx(sorted([0.3 / 12, 0.4 / 8]))
    assert loop.tpots(0.8, 1.2) == pytest.approx([0.2 / 4])
    assert loop.tokens(0.0, 0.35) == 1 + 4 + 4 + 4


def test_sample_takes_the_longest_first():
    import numpy as np
    loop = _loop([(0.0, 0.1, 0.0, [(0.1, n)], True) for n in (3, 9, 5, 7)])
    got = loop.sample(np.random.default_rng(0), 3)
    assert got[0].req.rid == 1 and len(got) == 3
    assert len({lv.req.rid for lv in got}) == 3


def test_union_and_idle_of_a_trace():
    tr = profile.Trace()
    tr.lo, tr.hi = 0, 100
    tr.ops = [("a", 10, 30), ("b", 20, 40), ("a", 60, 70)]
    tr.phases = {"step": [(0, 50)], "admit": [(5, 15)]}
    assert tr.busy_ns() == 40                    # 10-40 and 60-70
    assert tr.busy_ns([("a", 10, 30), ("a", 60, 70)]) == 30
    assert tr.device_ops() == [["a", 30e-9], ["b", 20e-9]]
    gaps = dict((n, v) for n, v in tr.idle_gaps(("admit", "step")))
    # 0-10 mid 5 in admit, 40-60 mid 50 outside step, 70-100 harness
    assert gaps == pytest.approx({"idle in admit": 10e-9,
                                  "idle in harness": 50e-9})
    assert [len(x) for x in tr.in_phase("step")] == [2]
    assert tr.label(12, ("admit", "step")) == "admit"
    assert tr.label(45, ("admit", "step")) == "step"


def test_decode_rows_count_idle_slots_and_the_edge():
    from portbench.lib import readers
    s = serving.StepRec(0, 1, 4, [(10, 4), (4094, 1)], 5, [], [], 0.01, True)
    # slot at 10: 11..14 rows; at 4094: 4095, then held at 4096 rows (the
    # cache's edge); 2 idle slots at 1..4
    assert [readers.decode_rows(s, i, 4, 4096) for i in range(4)] == [
        11 + 4095 + 2 * 1, 12 + 4096 + 2 * 2, 13 + 4096 + 2 * 3,
        14 + 4096 + 2 * 4]
