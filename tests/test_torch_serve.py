"""The port's serving engine (``repro_torch.serve``) on the CPU, held
against the JAX package's ``ServeEngine`` with the same weights (carried
over by ``params_from_numpy``) and the same prompts: greedy token streams
must be identical on the fused path at chunk 1 and 4 (max_new 6 ends
mid-chunk), on the legacy per-step path, and across a session export /
import; the PTT must have learned from as many samples.  Also: the port
runs with JAX and the JAX package unimportable.  Chunked prefill and the
prefill-role handoff are in ``test_torch_disagg.py``, the session wire in
``test_torch_wire.py``.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import get_model
from repro.serve import Request, ServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import SpanTracer
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import Session as TSession

# qwen2.5-3b: QKV bias, tied; starcoder2-15b: LayerNorm, GELU, bias, untied
ARCHS = ("qwen2-0.5b", "smollm-135m", "qwen2.5-3b", "starcoder2-15b")
MAX_SEQ = 32
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and the suite's other
    workers keep their cores (their latency-driven tests read wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_streams(pair):
    """The reference engine's token streams (and engine) per (arch, fused,
    chunk) for three 6-token prompts and max_new 6, run once per module."""
    cache = {}

    def get(arch, fused, chunk):
        key = (arch, fused, chunk)
        if key not in cache:
            jm, params, tm, _ = pair(arch)
            cache[key] = _run(ServeEngine, Request, jm, params,
                              _prompts(tm.cfg.vocab, 3, seed=0), 6,
                              fused=fused, decode_chunk=chunk)
        return cache[key]
    return get


@pytest.fixture(scope="module")
def pair():
    """Per arch: the reference (model, params) and the port's, same
    weights; built once per module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = get_model(get_config(arch, reduced=True))
            params = jax.jit(lambda key: jm.init(key)[0])(
                jax.random.PRNGKey(0))
            tc = tget_config(arch, reduced=True)
            tp = params_from_numpy(tc, jax.tree.map(np.asarray, params),
                                   "cpu")
            cache[arch] = (jm, params, tget_model(tc), tp)
        return cache[arch]
    return get


def _prompts(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, 6) for _ in range(n)]


def _run(engine_cls, req_cls, model, params, prompts, max_new, **kw):
    engine = engine_cls(model, params, max_batch=2, max_seq=MAX_SEQ, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_steps=200)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], engine


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fused,chunk", [(True, 1), (True, 4), (False, 1)])
def test_token_identity_with_jax_engine(pair, jax_streams, arch, fused,
                                       chunk):
    _, _, tm, tp = pair(arch)
    prompts = _prompts(tm.cfg.vocab, 3, seed=0)      # 3 requests, 2 slots
    want, jeng = jax_streams(arch, fused, chunk)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 6,
                     fused=fused, decode_chunk=chunk)
    assert got == want, (arch, fused, chunk, got, want)
    assert all(len(t) == 6 for t in got)             # surplus truncated
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates
    assert teng.stats()["requests_served"] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_export_import_token_identity(pair, jax_streams, arch):
    """A session exported mid-decode (host numpy leaves) and imported into
    a second engine continues the reference's unmigrated stream (a slot's
    tokens do not depend on the other slots, so the reference's first
    request of the legacy run is that stream)."""
    _, _, tm, tp = pair(arch)
    prompt = _prompts(tm.cfg.vocab, 3, seed=0)[0]
    want = jax_streams(arch, False, 1)[0][0]
    req = TRequest(rid=0, prompt=prompt.copy(), max_new=6)
    a = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    b = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    a.submit(req)
    a.step()                           # prefill token + one chunk of 2
    assert not req.done
    sess = a.export_session(req.rid)
    assert isinstance(sess, TSession) and sess.pos == 6 + 2
    assert all(isinstance(v, np.ndarray) for v in sess.cache.values())
    b.import_session(sess)
    b.run_until_drained(max_steps=100)
    assert req.done and list(req.out_tokens) == want
    assert a.stats()["sessions_exported"] == 1
    assert b.stats()["sessions_imported"] == 1


def test_last_step_latency_is_the_per_token_decode_latency(pair):
    """Set on every decode step to what ``on_step_latency`` receives
    (elapsed / chunk); steps that decode nothing leave it as it was."""
    _, _, tm, tp = pair("smollm-135m")
    eng = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    lat = []
    eng.on_step_latency = lat.append
    assert eng.last_step_latency == 0.0
    eng.submit(TRequest(rid=0, prompt=np.arange(5), max_new=5))
    while eng.step():
        assert eng.last_step_latency == lat[-1] > 0.0
    assert len(lat) == 2                  # 1 prefill token + 2 chunks of 2
    assert eng.step() == 0 and eng.last_step_latency == lat[-1]


def test_crash_restart_and_tracing(pair):
    _, _, tm, tp = pair("smollm-135m")
    eng = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    tracer = SpanTracer("t")
    eng.attach_obs(tracer=tracer, name="e0")
    eng.submit(TRequest(rid=7, prompt=np.arange(5), max_new=4))
    eng.step()
    eng.crash()
    assert eng.step() == 0 and eng.stats()["crashed"]
    eng.restart()
    req = TRequest(rid=8, prompt=np.arange(5), max_new=4)
    eng.submit(req)
    eng.run_until_drained(max_steps=50)
    assert req.done and len(req.out_tokens) == 4
    names = {e["name"] for e in tracer.timeline("t/r8")}
    assert {"prefill", "decode-chunk", "finish"} <= names


class _Child:
    def __init__(self):
        self.value = 0.0
        self.samples = []

    def inc(self, n=1.0):
        self.value += n

    def set(self, v):
        self.value = v

    def observe(self, v):
        self.samples.append(v)


class _Registry:
    """The metric-registry surface ``attach_obs`` uses (the reference's
    ``MetricRegistry`` is not ported yet)."""

    def __init__(self):
        self.children = {}

    def _child(self, name, help_, **labels):
        return self.children.setdefault(name, _Child())

    counter = histogram = gauge = _child


def test_attach_obs_metrics(pair):
    _, _, tm, tp = pair("qwen2-0.5b")
    eng = TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ, decode_chunk=2)
    reg = _Registry()
    eng.attach_obs(metrics=reg, name="e1")
    for i in range(3):
        eng.submit(TRequest(rid=i, prompt=np.arange(4) + i, max_new=5))
    eng.run_until_drained(max_steps=50)
    c = reg.children
    assert c["serve_requests_served_total"].value == 3
    assert len(c["serve_prefill_seconds"].samples) == 3
    steps = len(c["serve_decode_step_seconds"].samples)
    assert steps == eng.scheduler.ptt.updates - 3
    assert c["serve_decode_tokens_total"].value >= 3 * 4
    assert c["serve_utilization"].value == 0.0      # drained


def test_port_runs_without_jax():
    """Every repro_torch module imports, and a tiny CPU engine serves, with
    ``jax`` and ``repro`` made unimportable."""
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {str(SRC)!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "jax" not in {{m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None}}
        from repro_torch.configs import get_config
        from repro_torch.models import get_model
        from repro_torch.serve import Request, ServeEngine
        cfg = get_config("qwen2-0.5b", reduced=True)
        m = get_model(cfg)
        p = m.init(torch.Generator().manual_seed(0), "cpu")
        e = ServeEngine(m, p, max_batch=2, max_seq=16, decode_chunk=2)
        r = Request(rid=0, prompt=np.arange(5), max_new=3)
        e.submit(r)
        e.run_until_drained(max_steps=20)
        assert r.done and len(r.out_tokens) == 3
        print(len(names), "modules")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 20


def test_port_sources_import_no_jax_and_no_repro():
    """No source of the port, and not ``chip_smoke.py``, names ``jax``,
    ``ml_dtypes`` or the JAX package in an import."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|ml_dtypes|repro)(\.|\s|$)",
                     re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    assert len(files) > 40
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert hits == []
