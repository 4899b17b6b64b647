"""The port's session wire and transport (``repro_torch.region``) on the
CPU, held against the JAX package's ``repro.region``:

* **bytes**: one session encodes to the same bytes in both packages
  (fixed ``t_first`` / ``t_admit``), in float32 and bfloat16 (the JAX
  package's ``ml_dtypes`` leaves, the port's ``uint16`` bits), with and
  without the optional ``trace``, ``prefilled`` and ``delivery`` keys, in
  zlib and in the default codec;
* **reading the other package**: each decodes the other's bytes field for
  field, v1-v3 payloads included;
* **rejections**: truncation, a bit flip, a foreign magic, a version
  outside ``WIRE_COMPAT`` and an unknown codec raise ``WireFormatError``
  (fixed cases: no random draw lands on the version byte);
* **engines across packages**: a session exported mid-decode as wire bytes
  resumes token-identically on the other package's engine, both ways, on
  ``qwen2-0.5b`` and ``smollm-135m`` reduced, in float32 and bfloat16; the
  bfloat16 case handed in process to the JAX engine is the one the wire
  repairs (its stream goes wrong without an error);
* **transport**: ``LoopbackTransport``'s per-link counters and
  ``link_rtt``.

Tokens and bytes are exact; no tolerance applies.
"""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import get_model
from repro.region import wire as jwire
from repro.serve import Request, ServeEngine
from repro.serve import Session
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models import sessions as tsessions
from repro_torch.models.convert import params_from_numpy
from repro_torch.region import LoopbackTransport, ShipDropped
from repro_torch.region import wire as twire
from repro_torch.region.transport import DeliveryError, TransportError
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import Session as TSession

ARCHS = ("qwen2-0.5b", "smollm-135m")
MAX_SEQ = 32
OPTIONAL = {"trace": {"trace_id": "fleetA/r7"}, "prefilled": 5,
            "delivery": (2, 41, 3)}
# the key each version added; a vN payload holds only the keys up to vN
ADDED_IN = {"trace": 2, "prefilled": 3, "delivery": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# one session in both packages
# ---------------------------------------------------------------------------

def _sessions(dtype: str, optional=()):
    """The same session as the JAX package's and as the port's: the JAX
    cache leaves ``ml_dtypes`` bfloat16 where the port's are ``uint16``
    bits."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 1, 8, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 1, 8, 2, 4)).astype(np.float32)
    if dtype == "bfloat16":
        jcache = {"k": k.astype(ml_dtypes.bfloat16),
                  "v": v.astype(ml_dtypes.bfloat16)}
        tcache = {n: a.view(np.uint16) for n, a in jcache.items()}
    else:
        jcache, tcache = {"k": k, "v": v}, {"k": k.copy(), "v": v.copy()}
    req_kw = dict(rid=41, prompt=rng.integers(0, 1000, 9), max_new=7,
                  tenant="acme", out_tokens=[3, 1, 4], t_first=1.25,
                  t_admit=1.0,
                  extras={"frames": np.arange(6, dtype=np.float32)})
    extra = {name: OPTIONAL[name] for name in optional}
    js = Session(req=Request(**req_kw), pos=8, cur_token=4, cache=jcache,
                 **extra)
    ts = TSession(req=TRequest(**{**req_kw, "prompt": req_kw["prompt"]
                                  .copy()}),
                  pos=8, cur_token=4, cache=tcache, **extra)
    return js, ts


def _bits(a: np.ndarray) -> np.ndarray:
    """A leaf's raw bits, whatever names its dtype."""
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_same_session(a, b):
    """Field for field; cache leaves bit for bit."""
    for f in ("rid", "max_new", "tenant", "out_tokens", "done", "t_first",
              "t_admit"):
        assert getattr(a.req, f) == getattr(b.req, f), f
    np.testing.assert_array_equal(a.req.prompt, b.req.prompt)
    assert a.req.prompt.dtype == b.req.prompt.dtype
    assert a.req.extras.keys() == b.req.extras.keys()
    for name in a.req.extras:
        np.testing.assert_array_equal(a.req.extras[name], b.req.extras[name])
    for f in ("pos", "cur_token", "trace", "prefilled", "delivery"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.cache.keys() == b.cache.keys()
    for name in a.cache:
        assert a.cache[name].shape == b.cache[name].shape
        np.testing.assert_array_equal(_bits(a.cache[name]),
                                      _bits(b.cache[name]))


def _at_version(encode, sess, version: int) -> bytes:
    """A payload as a vN writer made it: only the optional keys up to vN,
    version byte N (the CRC covers the body only)."""
    for name, v in ADDED_IN.items():
        if v > version:
            setattr(sess, name, None)
    data = bytearray(encode(sess))
    data[4] = version
    return bytes(data)


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("optional", [(), ("trace",), ("prefilled",),
                                      ("delivery",), tuple(OPTIONAL)])
@pytest.mark.parametrize("codec", ("zlib", None))
def test_wire_bytes_identical_across_packages(dtype, optional, codec):
    js, ts = _sessions(dtype, optional)
    jb = jwire.encode_session(js, codec=codec)
    tb = twire.encode_session(ts, codec=codec)
    assert tb == jb
    assert twire.wire_header(tb) == jwire.wire_header(jb)


def test_bf16_cache_leaf_is_named_bfloat16():
    """The port's ``uint16`` cache leaf goes out as ``"bfloat16"`` and
    comes back as ``uint16`` bits; the prompt keeps its own dtype."""
    import msgpack
    _, ts = _sessions("bfloat16")
    ts.req.prompt = ts.req.prompt.astype(np.uint16)
    data = twire.encode_session(ts, codec="zlib")
    body = msgpack.unpackb(twire.decompress(data[10:], "zlib"), raw=False)
    assert {body["cache"][n]["dtype"] for n in ("k", "v")} == {"bfloat16"}
    assert body["req"]["prompt"]["dtype"] == "uint16"
    out = twire.decode_session(data)
    assert out.cache["k"].dtype == np.uint16
    _assert_same_session(out, ts)


def test_extract_session_refuses_an_integer_cache_leaf():
    """The rule "a ``uint16`` cache leaf is bfloat16" holds only while no
    cache has an integer leaf; extraction checks it."""
    cache = {"k": torch.zeros((1, 2, 4, 1, 2)),
             "state": torch.zeros((1, 2, 3), dtype=torch.int16)}
    axes = {"k": (None, "batch", "seq_mp", None, None),
            "state": (None, "batch", None)}
    with pytest.raises(TypeError, match="floating-point"):
        tsessions.extract_session(cache, 0, 2, axes, {"k": 2, "state": None})


# ---------------------------------------------------------------------------
# reading the other package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("version", (1, 2, 3, 4))
def test_each_package_decodes_the_others_bytes(dtype, version):
    js, ts = _sessions(dtype, tuple(OPTIONAL))
    from_jax = _at_version(jwire.encode_session, js, version)
    from_port = _at_version(twire.encode_session, ts, version)
    assert from_port == from_jax
    t_out = twire.decode_session(from_jax)
    j_out = jwire.decode_session(from_port)
    _assert_same_session(t_out, ts)
    _assert_same_session(j_out, js)
    assert twire.wire_header(from_jax)["version"] == version
    if dtype == "bfloat16":
        assert t_out.cache["k"].dtype == np.uint16
        assert j_out.cache["k"].dtype == np.dtype(ml_dtypes.bfloat16)
    expect = {name: (OPTIONAL[name] if ADDED_IN[name] <= version else None)
              for name in OPTIONAL}
    assert {name: getattr(t_out, name) for name in OPTIONAL} == expect


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

def _mutations(data: bytes):
    flipped = bytearray(data)
    flipped[len(data) // 2] ^= 0x10
    foreign = b"XXXX" + data[4:]
    codec = bytearray(data)
    codec[5] = 99
    out = [("truncated", data[:-3], "checksum"),
           ("too short", data[:4], "too short"),
           ("bit flip", bytes(flipped), "checksum"),
           ("foreign magic", foreign, "magic"),
           ("unknown codec", bytes(codec), "codec")]
    for v in (0, 5, 255):
        bad = bytearray(data)
        bad[4] = v
        out.append((f"version {v}", bytes(bad), "version"))
    return out


@pytest.mark.parametrize("case", range(8))
def test_corrupt_payloads_raise_wire_format_error(case):
    _, ts = _sessions("bfloat16", tuple(OPTIONAL))
    data = twire.encode_session(ts)
    name, bad, match = _mutations(data)[case]
    with pytest.raises(twire.WireFormatError, match=match):
        twire.decode_session(bad)
    with pytest.raises(jwire.WireFormatError, match=match):
        jwire.decode_session(bad)       # the reference refuses alike


def test_unknown_codec_name_raises_on_encode():
    _, ts = _sessions("float32")
    with pytest.raises(twire.WireFormatError, match="codec"):
        twire.encode_session(ts, codec="lz4")
    assert twire.verify_crc(twire.encode_session(ts))["version"] == 4


def test_engine_refuses_corrupt_bytes_before_touching_state(pair):
    _, _, tm, tp = pair("smollm-135m", None)
    a = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    b = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    a.submit(TRequest(rid=0, prompt=np.arange(6), max_new=8))
    a.step()
    data = bytearray(a.export_session_wire(0))
    data[-1] ^= 0xFF
    with pytest.raises(twire.WireFormatError):
        b.import_session_wire(bytes(data))
    assert b.pending() == 0 and b.stats()["sessions_imported"] == 0


# ---------------------------------------------------------------------------
# engines across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """Per (arch, compute dtype): the reference (model, params) and the
    port's, same weights; built once per module."""
    cache = {}

    def get(arch, dtype):
        key = (arch, dtype)
        if key not in cache:
            jc = get_config(arch, reduced=True)
            tc = tget_config(arch, reduced=True)
            if dtype is not None:
                jc = dataclasses.replace(jc, compute_dtype=dtype)
                tc = dataclasses.replace(tc, compute_dtype=dtype)
            jm = get_model(jc)
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[key] = (jm, params, tget_model(tc), tp)
        return cache[key]
    return get


def _prompt(vocab):
    """The serve tests' first prompt (default_rng(0), three drawn)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 6) for _ in range(3)][0]


def _unmigrated(engine_cls, req_cls, model, params, prompt):
    e = engine_cls(model, params, max_batch=2, max_seq=MAX_SEQ,
                   decode_chunk=2)
    r = req_cls(rid=0, prompt=prompt.copy(), max_new=8)
    e.submit(r)
    e.run_until_drained(max_steps=100)
    return list(r.out_tokens)


def _over_the_wire(src, src_req, dst, prompt):
    """Prefill and one chunk of 2 on ``src``, then wire bytes to ``dst``
    and on to the end there; returns the decoded request's tokens."""
    src.submit(src_req(rid=0, prompt=prompt.copy(), max_new=8, tenant=7))
    src.step()
    dst.import_session_wire(src.export_session_wire(0))
    handle = dst.sessions_in[-1].req
    assert handle.tenant == 7
    dst.run_until_drained(max_steps=100)
    assert handle.done
    return list(handle.out_tokens)


def _in_process(src, src_req, dst, prompt, to_jax: bool):
    """As :func:`_over_the_wire`, but the session handed over in process
    with its cache bits intact: a port session's ``uint16`` leaves are
    viewed as ``ml_dtypes`` bfloat16 for the JAX engine."""
    req = src_req(rid=0, prompt=prompt.copy(), max_new=8)
    src.submit(req)
    src.step()
    sess = src.export_session(0)
    if to_jax:
        sess.cache = {n: (a.view(ml_dtypes.bfloat16) if a.dtype == np.uint16
                          else a) for n, a in sess.cache.items()}
    dst.import_session(sess)
    dst.run_until_drained(max_steps=100)
    assert req.done
    return list(req.out_tokens)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", (None, "bfloat16"))
@pytest.mark.parametrize("direction", ("jax->port", "port->jax"))
def test_engines_resume_across_packages_over_the_wire(pair, arch, dtype,
                                                      direction):
    """Over the wire the destination resumes exactly as from the session
    handed over in process with its bits intact, and that is the
    unmigrated stream wherever the two packages' unmigrated streams agree.
    They agree in float32; in bfloat16 the packages round GEMMs
    differently, and smollm-135m's streams part at a near-tie (the 6th
    token), where no single stream is the target."""
    jm, params, tm, tp = pair(arch, dtype)
    prompt = _prompt(tm.cfg.vocab)
    jax_side = (ServeEngine, Request, jm, params)
    port_side = (TServeEngine, TRequest, tm, tp)
    src, dst = ((jax_side, port_side) if direction == "jax->port"
                else (port_side, jax_side))

    def engine(side):
        return side[0](side[2], side[3], max_batch=2, max_seq=MAX_SEQ,
                       decode_chunk=2)

    got = _over_the_wire(engine(src), src[1], engine(dst), prompt)
    assert got == _in_process(engine(src), src[1], engine(dst), prompt,
                              to_jax=direction == "port->jax")
    want = _unmigrated(*src, prompt)
    agree = want == _unmigrated(*dst, prompt)
    assert agree or (arch, dtype) == ("smollm-135m", "bfloat16")
    if agree:
        assert got == want, (arch, dtype, direction, got, want)


def test_bf16_port_session_resumes_on_jax_engine_over_the_wire(pair):
    """The port-to-JAX bfloat16 fault: handed in process, the port's
    ``uint16`` leaves are converted by value and the stream goes wrong;
    over the wire it is the unmigrated stream."""
    jm, params, tm, tp = pair("qwen2-0.5b", "bfloat16")
    prompt = _prompt(tm.cfg.vocab)
    want = [15, 15, 15, 112, 112, 112, 8, 8]
    assert _unmigrated(ServeEngine, Request, jm, params, prompt) == want
    t = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    j = ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    assert _over_the_wire(t, TRequest, j, prompt) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_mid_prefill_session_crosses_the_wire(pair, arch):
    """A chunked prefill exported after one chunk travels as bytes (v3's
    ``prefilled``) to the JAX chunked engine and finishes there as the
    unmigrated chunked stream does."""
    jm, params, tm, tp = pair(arch, None)
    prompt = np.random.default_rng(3).integers(0, tm.cfg.vocab, 11)
    e = ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2,
                    prefill_chunk_tokens=4)
    ref = Request(rid=0, prompt=prompt.copy(), max_new=6)
    e.submit(ref)
    e.run_until_drained(max_steps=100)
    t = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2,
                     prefill_chunk_tokens=4)
    t.submit(TRequest(rid=0, prompt=prompt.copy(), max_new=6))
    t.step()
    sess = t.export_prefill(0)
    assert sess.prefilled == 4
    j = ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2,
                    prefill_chunk_tokens=4)
    j.import_session(jwire.decode_session(twire.encode_session(sess)))
    handle = j.prefilling[0].req
    j.run_until_drained(max_steps=100)
    assert handle.done and handle.out_tokens == ref.out_tokens


def test_drain_and_handoff_keep_tenant_and_delivery(pair):
    """Imported sessions leave ``drain_sessions`` as they came (their
    ``delivery`` id with them), and a prefill-role handoff keeps the
    request, ``tenant`` included."""
    _, _, tm, tp = pair("smollm-135m", None)
    _, ts = _sessions("float32", ("delivery",))
    sess = twire.decode_session(twire.encode_session(ts))
    e = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ)
    e.import_session(sess, strict=False)
    out = e.drain_sessions()
    assert out == [sess] and sess.delivery == OPTIONAL["delivery"]
    assert sess.req.tenant == "acme"
    got = []
    pre = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, role="prefill")
    pre.on_prefill_complete = got.append
    pre.submit(TRequest(rid=5, prompt=np.arange(6), max_new=4, tenant=3))
    pre.step()
    assert got[0].req.tenant == 3 and got[0].delivery is None


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

def test_loopback_transport_counts_and_link_rtt():
    t = LoopbackTransport(link_rtt=lambda s, d: 0.01 * (s + 1) + d)
    out, rtt = t.ship(b"abc", 0, 1)
    assert out == b"abc" and rtt == pytest.approx(1.01)
    t.ship(b"defgh", 0, 1)
    t.ship(b"z", 2, 0)
    assert dict(t.bytes_by_link) == {(0, 1): 8, (2, 0): 1}
    assert dict(t.ships_by_link) == {(0, 1): 2, (2, 0): 1}
    assert t.total_bytes == 9 and t.total_ships == 3
    plain = LoopbackTransport()
    assert plain.ship(b"x", 3, 4) == (b"x", 0.0)
    assert issubclass(ShipDropped, TransportError)
    assert issubclass(DeliveryError, TransportError)
    err = DeliveryError(0, 1, 3, ShipDropped(0, 1))
    assert err.attempts == 3 and "after 3 attempts" in str(err)


def test_session_rides_the_loopback_transport(pair):
    """Engine to engine through a ``LoopbackTransport``: the bytes that
    arrive are the bytes shipped, counted on their link."""
    _, _, tm, tp = pair("smollm-135m", None)
    a = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    b = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    a.submit(TRequest(rid=0, prompt=np.arange(6), max_new=6))
    a.step()
    data = a.export_session_wire(0)
    link = LoopbackTransport()
    arrived, _ = link.ship(data, 0, 1)
    b.import_session_wire(arrived)
    b.run_until_drained(max_steps=50)
    assert link.bytes_by_link[(0, 1)] == len(data)
    assert b.stats()["sessions_imported"] == 1 and b.stats()[
        "requests_served"] == 1
