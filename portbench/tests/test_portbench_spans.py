"""The readers of the engine's own spans (``prefill_dispatch_ms``,
``prefill_device_ms``, ``prefill_moe_host_ms``, ``step_host_ms``,
``ptt_us``, ``prefill_attn_host_ms``) on a ``SpanTracer`` with scripted events and a
``profile.Trace`` with scripted operations, each number worked out by hand
in the comments; and each reader's silence where there is nothing to read
(a parent commit's spans, which carry none of these)."""

import types

import pytest

from portbench import run
from portbench.lib import profile

NAMES = ("prefill_dispatch_ms", "prefill_device_ms", "prefill_moe_host_ms",
         "step_host_ms", "ptt_us", "prefill_attn_host_ms")
UNIX0 = 7_000_000_000            # the Unix ns of clock 0.0 (the one anchor)


def _step(tr, track, no, ts, dur, ptt_ns):
    tr.complete("step", track, track, ts=ts, dur=dur, step=no, k=4,
                active=2, prefills=0, ptt_updates=3, ptt_ns=ptt_ns)


def _decode(tr, track, no, ts, launch, wait):
    tr.complete("decode.launch", track, track, ts=ts, dur=launch, step=no)
    tr.complete("decode.wait", track, track, ts=ts + launch, dur=wait,
                step=no)


def _prefill(tr, rid, no, ts, dispatch, sync, moe, attn):
    """A whole prefill: ``dispatch``, then ``sync`` s of its argmax, which
    no span of its own marks; its MoE and then its attention spans."""
    tid = f"pb/r{rid}"
    tr.complete("prefill", tid, "e0", ts=ts, dur=dispatch + sync,
                prompt_len=8, step=no)
    tr.complete("prefill.dispatch", tid, "e0", ts=ts, dur=dispatch, step=no)
    tr.events.append({"name": "finish", "ph": "i", "ts": ts + dispatch,
                      "trace": tid, "track": "e0", "args": {},
                      "tick": None})                # an instant: no dur
    t = ts
    for name, dur in zip(("moe.route", "moe.dispatch", "moe.experts",
                          "moe.combine") + ("attn",) * len(attn),
                         moe + attn):
        tr.complete(name, tid, "e0", ts=t, dur=dur, step=no)
        t += dur


@pytest.fixture
def spans(monkeypatch):
    """A window [10, 20] s of two engines on one tracer: e0 steps 1-3 (two
    whole prefills at step 3), e1 a step 1 of its own, and a step and a
    prefill outside the window."""
    from repro_torch.obs import SpanTracer
    from repro_torch.obs import trace as obs_trace
    monkeypatch.setattr(obs_trace, "time",
                        types.SimpleNamespace(time_ns=lambda: UNIX0))
    tr = SpanTracer("pb", clock=lambda: 0.0)
    tr.anchor()                  # clock 0.0 <-> UNIX0
    # e0 step 1: 100 ms; a prefill of 50 (45 dispatch, 5 sync), decode
    # 10 + 15, the tracer's recording 5: self 100 - 80 = 20 ms; MoE
    # 2 + 3 + 4 + 1 = 10 ms, attention 3 + 4 = 7
    _step(tr, "e0", 1, 11.0, 0.100, 30_000)
    _prefill(tr, 1, 1, 11.010, 0.045, 0.005, (0.002, 0.003, 0.004, 0.001),
             (0.003, 0.004))
    _decode(tr, "e0", 1, 11.070, 0.010, 0.015)
    tr.complete("trace.record", "e0", "e0", ts=11.095, dur=0.005, step=1)
    # e0 step 2: 40 ms, decode 10 + 20: self 10 ms
    _step(tr, "e0", 2, 12.0, 0.040, 10_000)
    _decode(tr, "e0", 2, 12.005, 0.010, 0.020)
    # e0 step 3: 200 ms; prefills of 80 (70 + 10) and 60 (50 + 10), decode
    # 10 + 30: self 200 - 180 = 20 ms; MoE 30 and 20 ms, attention 25 and
    # 11
    _step(tr, "e0", 3, 13.0, 0.200, 50_000)
    _prefill(tr, 2, 3, 13.0, 0.070, 0.010, (0.005, 0.010, 0.012, 0.003),
             (0.010, 0.015))
    _prefill(tr, 3, 3, 13.080, 0.050, 0.010, (0.004, 0.006, 0.008, 0.002),
             (0.005, 0.006))
    _decode(tr, "e0", 3, 13.150, 0.010, 0.030)
    # e1 step 1 (the same index on another track): 50 ms, decode 10 + 10:
    # self 30 ms
    _step(tr, "e1", 1, 14.0, 0.050, 10_000)
    _decode(tr, "e1", 1, 14.010, 0.010, 0.010)
    # outside the window
    _step(tr, "e0", 9, 25.0, 0.500, 999_999)
    _prefill(tr, 9, 9, 5.0, 0.400, 0.010, (0.1, 0.1, 0.1, 0.1), (0.1,))
    return tr


def _trace():
    """A slice from clock 12.5 to 14.5 s (so the prefills of step 3
    alone): operations, as ms after 13.0 s, at 10-30 and 25-40 (30 ms of
    union, inside r2's 0-80), 75-85 (5 in r2, 5 in r3's 80-140) and 90-100
    (r3's): r2 35 ms busy, r3 15."""
    base = UNIX0 + 13_000_000_000
    ms = 1_000_000
    tr = profile.Trace()
    tr.lo, tr.hi = UNIX0 + 12_500_000_000, UNIX0 + 14_500_000_000
    tr.ops = [("k", base + a * ms, base + b * ms)
              for a, b in ((10, 30), (25, 40), (75, 85), (90, 100))]
    return tr


def _L(spans, trace=None):
    return {"loop": types.SimpleNamespace(spans=spans), "t0": 10.0,
            "t_close": 20.0, "trace": trace}


def test_prefill_dispatch_ms_is_the_median_dispatch(spans):
    # 45, 70, 50 ms inside the window (400 outside)
    assert run._reader("prefill_dispatch_ms")(_L(spans)) == pytest.approx(50)


def test_prefill_moe_host_ms_sums_a_prefills_moe_spans(spans):
    # r1 10, r2 30, r3 20 ms (r2 and r3 share step 3, not their trace)
    assert run._reader("prefill_moe_host_ms")(_L(spans)) == pytest.approx(20)


def test_prefill_attn_host_ms_sums_a_prefills_attention_spans(spans):
    # r1 7, r2 25, r3 11 ms
    assert run._reader("prefill_attn_host_ms")(_L(spans)) == pytest.approx(
        11)


def test_step_host_ms_is_the_median_self_time(spans):
    # e0 20, 10, 20; e1 30 (its children are not e0's step 1's)
    assert run._reader("step_host_ms")(_L(spans)) == pytest.approx(20)


def test_ptt_us_is_the_windows_ptt_time_over_its_steps(spans):
    # (30 + 10 + 50 + 10) us over 4 steps
    assert run._reader("ptt_us")(_L(spans)) == pytest.approx(25)


def test_prefill_device_ms_is_the_busy_time_inside_mapped_prefills(spans):
    # r2 35 ms, r3 15 ms; r1 lies before the slice
    got = run._reader("prefill_device_ms")(_L(spans, _trace()))
    assert got == pytest.approx(25)
    assert run._reader("prefill_device_ms")(_L(spans)) is None


def test_trace_ns_maps_through_the_last_anchor(monkeypatch):
    from repro_torch.obs import SpanTracer
    from repro_torch.obs import trace as obs_trace
    now = {"clock": 1.0, "unix": 5_000_000_000}
    monkeypatch.setattr(obs_trace, "time", types.SimpleNamespace(
        time_ns=lambda: now["unix"]))
    tr = SpanTracer("pb", clock=lambda: now["clock"])
    tr.anchor()                                  # 1.0 s <-> 5e9
    now.update(clock=3.0, unix=7_000_000_100)    # the clocks drift 100 ns
    tr.anchor()
    assert tr.trace_ns(0.5) == 4_500_000_000     # before the first: the first
    assert tr.trace_ns(2.0) == 6_000_000_000
    assert tr.trace_ns(3.5) == 7_500_000_100


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_reads_nothing_from_nothing(name):
    assert run._reader(name)({}) is None


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_is_silent_on_a_parent_commits_spans(name):
    """The parent's engine records only ``prefill`` spans (no step index)
    through a tracer with no ``trace_ns``: nothing to read, no raise."""
    events = [{"name": "prefill", "ph": "X", "ts": 11.0, "dur": 0.05,
               "trace": "pb/r1", "track": "engine",
               "args": {"prompt_len": 8}},
              {"name": "finish", "ph": "i", "ts": 11.05, "trace": "pb/r1",
               "track": "engine", "args": {"tokens": 1}}]
    parent = types.SimpleNamespace(events=events)
    assert run._reader(name)(_L(parent, _trace())) is None
    assert run._reader(name)(_L(None)) is None
