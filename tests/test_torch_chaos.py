"""The port's chaos transports (``repro_torch.chaos``) on the CPU, held
against the JAX package's ``repro.chaos`` on the same seeds and payloads:

* ``ChaosTransport`` under one ``FaultInjector`` seed and plan (per-link
  rates, a partition window, the logical clock advanced between ships):
  the same delivered bytes, flipped bits, drop reasons, reported delays,
  duplicate queue and injector counters as the JAX one;
* ``ReliableTransport`` over it: the same counts, simulated backoff
  sequence (caps and seeded jitter), CRC retries, ``DeliveryError`` on an
  exhausted budget and ``chaos_*`` metric values; duplicates pass through;
* port engines behind a chaos-wrapped prefill -> decode ``FleetGateway``
  emit the JAX engine's monolithic stream on every family
  (``tests/test_chaos.py::test_chaos_token_identity_every_family``'s
  archs and rates; the vlm's cross gates set nonzero).

Everything but the engines is host-side Python on both sides, so every
comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from repro.chaos import ChaosTransport as JChaos
from repro.chaos import FaultInjector as JInjector
from repro.chaos import ReliableTransport as JReliable
from repro.configs import get_config
from repro.models import get_model
from repro.obs import MetricRegistry as JRegistry
from repro.region import transport as jtransport
from repro.serve import Request, ServeEngine
from repro_torch.chaos import ChaosTransport, DeliveryError, FaultInjector
from repro_torch.chaos import ReliableTransport
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import MetricRegistry
from repro_torch.region import LoopbackTransport, ShipDropped, Transport
from repro_torch.region import wire as twire
from repro_torch.router import FleetGateway
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import Session as TSession

PKGS = {
    "jax": dict(Chaos=JChaos, Injector=JInjector, Reliable=JReliable,
                Loopback=jtransport.LoopbackTransport,
                Dropped=jtransport.ShipDropped,
                DeliveryError=jtransport.DeliveryError,
                Registry=JRegistry),
    "torch": dict(Chaos=ChaosTransport, Injector=FaultInjector,
                  Reliable=ReliableTransport, Loopback=LoopbackTransport,
                  Dropped=ShipDropped, DeliveryError=DeliveryError,
                  Registry=MetricRegistry),
}
GATES = {"gate_attn": [0.7, 0.5], "gate_mlp": [-0.4, 0.3]}   # per superblock
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payloads(n, seed=0):
    """``n`` valid wire payloads (synthetic float32 sessions), so that the
    reliable layer's CRC check passes on every clean delivery."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cache = {"k": rng.standard_normal((1, 1, 3 + i % 4, 2, 4)).astype(
            np.float32)}
        sess = TSession(req=TRequest(rid=i, prompt=np.arange(5), max_new=4),
                        pos=3 + i % 4, cur_token=1, cache=cache)
        out.append(twire.encode_session(sess, codec="zlib"))
    return out


def _injector(pkg, seed):
    return (PKGS[pkg]["Injector"](seed)
            .default_link(drop=0.2, corrupt=0.15, duplicate=0.3, delay=0.05)
            .link(1, 0, drop=0.5, delay=0.2)
            .partition(0, 2, start=3, until=6))


def _chaos_run(pkg, seed, payloads):
    P = PKGS[pkg]
    inj = _injector(pkg, seed)
    inner = P["Loopback"](lambda s, d: 0.01 * (1 + s + 2 * d))
    ct = P["Chaos"](inner, inj)
    out = []
    for i, data in enumerate(payloads):
        src, dst = [(0, 1), (1, 0), (0, 2)][i % 3]
        try:
            delivered, rtt = ct.ship(data, src, dst)
            flips = [j for j, (a, b) in enumerate(zip(delivered, data))
                     if a != b]
            out.append(("ok", src, dst, delivered, flips, rtt))
        except P["Dropped"] as e:
            out.append(("dropped", e.src, e.dst, e.reason))
        if i % 2:
            inj.advance()
        if i % 5 == 4:
            out.append(("dups", ct.take_duplicates()))
    return out, ct.stats(), dict(inner.bytes_by_link), inner.total_ships


@pytest.mark.parametrize("seed", (0, 3, 11))
def test_chaos_transport_matches_jax(seed):
    payloads = _payloads(60, seed)
    got = _chaos_run("torch", seed, payloads)
    want = _chaos_run("jax", seed, payloads)
    assert got == want
    events, stats, _, ships = got
    kinds = {e[0] for e in events}
    assert {"ok", "dropped"} <= kinds, kinds
    assert any(e[0] == "dropped" and e[3] == "partitioned" for e in events)
    # a corrupted delivery differs from the payload in exactly one bit
    flipped = [e for e in events if e[0] == "ok" and e[4]]
    assert flipped and all(len(e[4]) == 1 for e in flipped)
    assert stats["corrupt"] == len(flipped) and ships == len(payloads)


def test_chaos_transport_each_fault_alone():
    """``tests/test_chaos.py``'s single-fault cases on the port: a drop
    still charges the inner link, a corruption flips one bit of the
    delivered copy only, a duplicate queues once, a delay adds to the
    reported rtt."""
    payload = b"x" * 64
    inner = LoopbackTransport()
    ct = ChaosTransport(inner, FaultInjector(0).default_link(drop=1.0))
    with pytest.raises(ShipDropped) as ei:
        ct.ship(payload, 0, 1)
    assert ei.value.reason == "dropped" and inner.total_ships == 1
    ct = ChaosTransport(LoopbackTransport(),
                        FaultInjector(1).default_link(corrupt=1.0))
    delivered, _ = ct.ship(payload, 0, 1)
    diff = [a ^ b for a, b in zip(delivered, payload)]
    assert sum(bin(d).count("1") for d in diff) == 1
    assert payload == b"x" * 64
    ct = ChaosTransport(LoopbackTransport(),
                        FaultInjector(2).default_link(duplicate=1.0))
    delivered, _ = ct.ship(payload, 0, 1)
    assert ct.take_duplicates() == [(0, 1, delivered)]
    assert ct.take_duplicates() == []
    ct = ChaosTransport(LoopbackTransport(lambda s, d: 0.25),
                        FaultInjector(3).default_link(delay=0.5))
    assert ct.ship(payload, 0, 1)[1] == pytest.approx(0.75)


# ---------------------------------------------------------------------------
# ReliableTransport
# ---------------------------------------------------------------------------

def _reliable_run(pkg, seed, payloads, max_attempts, jitter):
    P = PKGS[pkg]
    reg = P["Registry"]()
    rt = P["Reliable"](P["Chaos"](P["Loopback"](), _injector(pkg, seed)),
                       max_attempts=max_attempts, base_backoff=0.05,
                       max_backoff=0.3, jitter=jitter, seed=seed)
    rt.attach_obs(registry=reg)
    out = []
    for i, data in enumerate(payloads):
        src, dst = [(0, 1), (1, 0), (0, 2)][i % 3]
        try:
            delivered, rtt = rt.ship(data, src, dst)
            assert delivered == data              # clean bytes or a retry
            out.append(("ok", rtt))
        except P["DeliveryError"] as e:
            out.append(("failed", e.src, e.dst, e.attempts,
                        type(e.cause).__name__))
        rt.inner.injector.advance()
        out.append(("dups", len(rt.take_duplicates())))
    text = "\n".join(line for line in reg.prometheus_text().splitlines()
                     if line.startswith("chaos_"))
    return out, rt.stats(), text


@pytest.mark.parametrize("seed,max_attempts,jitter", [(0, 4, 0.02),
                                                      (5, 2, 0.0),
                                                      (11, 6, 0.05)])
def test_reliable_transport_matches_jax(seed, max_attempts, jitter):
    payloads = _payloads(60, seed)
    got = _reliable_run("torch", seed, payloads, max_attempts, jitter)
    want = _reliable_run("jax", seed, payloads, max_attempts, jitter)
    assert got == want
    out, counts, text = got
    assert counts["retries"] > 0 and counts["corrupt"] > 0
    assert counts["attempts"] == counts["delivered"] + counts["drops"] \
        + counts["corrupt"]
    assert f"chaos_ship_attempts_total {counts['attempts']}" in text
    if max_attempts == 2:                   # a budget this small runs out
        assert counts["exhausted"] > 0
        assert any(e[0] == "failed" for e in out)


def test_reliable_backoff_sequence_matches_jax():
    """Capped, seeded jitter: the same draws in both packages, each within
    ``[base * 2**a capped, + jitter)``."""
    got = ReliableTransport(LoopbackTransport(), max_attempts=8,
                            base_backoff=0.1, max_backoff=0.3, jitter=0.05,
                            seed=4)
    want = JReliable(jtransport.LoopbackTransport(), max_attempts=8,
                     base_backoff=0.1, max_backoff=0.3, jitter=0.05, seed=4)
    backs = [got._backoff(a) for a in range(8)]
    assert backs == [want._backoff(a) for a in range(8)]
    for a, b in enumerate(backs):
        base = min(0.1 * 2 ** a, 0.3)
        assert base <= b < base + 0.05


class _Flaky(Transport):
    """Fails the first ``fail`` ships (drop or corrupt), then delivers."""

    def __init__(self, fail, mode, rtt=0.1):
        self.fail, self.mode, self.rtt, self.ships = fail, mode, rtt, 0

    def ship(self, data, src, dst):
        self.ships += 1
        if self.ships <= self.fail:
            if self.mode == "drop":
                raise ShipDropped(src, dst, "flaky")
            buf = bytearray(data)
            buf[len(buf) // 2] ^= 0x40     # mid-body: the CRC catches it
            return bytes(buf), self.rtt
        return data, self.rtt


@pytest.mark.parametrize("mode", ("drop", "corrupt"))
def test_reliable_retries_until_delivered(mode):
    data = _payloads(1)[0]
    inner = _Flaky(2, mode)
    rt = ReliableTransport(inner, max_attempts=4, base_backoff=0.05,
                           jitter=0.0)
    delivered, rtt = rt.ship(data, 0, 1)
    assert delivered == data and inner.ships == 3
    # a flaky link reports as a slow link: the failed attempts' rtts and
    # both simulated backoffs (0.05, 0.10)
    lost = 0.0 if mode == "drop" else 2 * 0.1
    assert rtt == pytest.approx(0.1 + lost + 0.05 + 0.10)
    assert rt.counts["retries"] == 2
    assert rt.counts["drops" if mode == "drop" else "corrupt"] == 2


def test_reliable_exhaustion_raises_typed_error_with_metrics():
    inner = ChaosTransport(LoopbackTransport(),
                           FaultInjector(5).default_link(drop=1.0))
    rt = ReliableTransport(inner, max_attempts=3, jitter=0.0)
    reg = MetricRegistry()
    rt.attach_obs(registry=reg)
    with pytest.raises(DeliveryError) as ei:
        rt.ship(b"y" * 32, 2, 4)
    e = ei.value
    assert (e.src, e.dst, e.attempts) == (2, 4, 3)
    assert isinstance(e.cause, ShipDropped)
    assert rt.counts["exhausted"] == 1 and rt.counts["attempts"] == 3
    text = reg.prometheus_text()
    assert "chaos_ship_attempts_total 3" in text
    assert "chaos_delivery_exhausted_total 1" in text


def test_reliable_passes_through_duplicates():
    inner = ChaosTransport(LoopbackTransport(),
                           FaultInjector(6).default_link(duplicate=1.0))
    rt = ReliableTransport(inner, jitter=0.0, verify=False)
    delivered, _ = rt.ship(b"z" * 16, 0, 1)
    assert rt.take_duplicates() == [(0, 1, delivered)]
    assert rt.take_duplicates() == []
    assert ReliableTransport(LoopbackTransport()).take_duplicates() == []


# ---------------------------------------------------------------------------
# token identity under chaos across every model family
# ---------------------------------------------------------------------------

def _pair(arch):
    """The reference (model, params) and the port's, same weights (the
    vlm's cross gates nonzero)."""
    jc = get_config(arch, reduced=True)
    jm = get_model(jc)
    params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    if jc.family == "vlm":
        for name, vals in GATES.items():
            tree["cross_layers"][name] = np.asarray(vals, np.float32)
        params = jax.tree.map(jax.numpy.asarray, tree)
    tc = tget_config(arch, reduced=True)
    return jm, params, tget_model(tc), params_from_numpy(tc, tree, "cpu")


def _requests(cfg, n):
    rng = np.random.default_rng(8)
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(7), (cfg.n_image_tokens, cfg.d_model)))
    return [(rid, rng.integers(0, cfg.vocab, 8), extras)
            for rid in range(n)]


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "granite-moe-1b-a400m",
                                  "mamba2-130m", "jamba-v0.1-52b",
                                  "llama-3.2-vision-90b"))
def test_chaos_token_identity_every_family(arch):
    """A prefill replica handing each session to a decode replica over a
    lossy, corrupting, duplicating transport: every port stream equals the
    JAX engine's monolithic stream, every request is handed off once, and
    the duplicated delivery is deduplicated, not adopted twice."""
    jm, params, tm, tp = _pair(arch)
    reqs = _requests(tm.cfg, 2)
    want = []
    for rid, prompt, extras in reqs:
        e = ServeEngine(jm, params, max_batch=2, max_seq=32)
        r = Request(rid=rid, prompt=prompt.copy(), max_new=MAX_NEW,
                    extras=dict(extras))
        e.submit(r)
        e.run_until_drained(max_steps=300)
        want.append(list(r.out_tokens))
    inj = FaultInjector(13).default_link(drop=0.15, corrupt=0.1,
                                         duplicate=0.25)
    transport = ReliableTransport(ChaosTransport(LoopbackTransport(), inj),
                                  max_attempts=8, jitter=0.0, seed=13)
    pre = TServeEngine(tm, tp, max_batch=2, max_seq=32, role="prefill")
    dec = TServeEngine(tm, tp, max_batch=2, max_seq=32, role="decode")
    gw = FleetGateway([pre, dec], transport=transport, injector=inj)
    for rid, prompt, extras in reqs:
        gw.submit(TRequest(rid=rid, prompt=prompt.copy(), max_new=MAX_NEW,
                           extras=dict(extras)))
    gw.run_until_drained(400)
    got = [gw.handle(rid) for rid, _, _ in reqs]
    assert all(h.done for h in got)
    assert [list(h.out_tokens) for h in got] == want, arch
    st = gw.stats()
    assert st["prefill_handoffs"] == len(reqs)
    assert st["requests_served"] == len(reqs)
    assert transport.counts["delivered"] == len(reqs)
    # the seed duplicates a handoff: the copy is deduplicated, not adopted
    assert st["duplicates_deduped"] == inj.counts["duplicate"] >= 1
