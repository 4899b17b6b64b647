"""The port's vlm family (``repro_torch.models.vlm``) on the CPU, held
against the JAX package's ``repro.models.vlm`` with the same inputs and
weights (carried over by ``params_from_numpy``), on
``llama-3.2-vision-90b`` reduced (10 layers: two superblocks of 4 self
layers and 1 gated cross layer, 9 image tokens):

* cross-attention alone: the prefill (K and V from the image, no RoPE,
  non-causal) and the cross decode against the JAX ``attention_apply``;
* the model: ``prefill`` logits and all four cache leaves, several ragged
  decode steps (the self leaves written in place, the cross leaves never),
  and the port's ``prefill`` + ``decode`` against its own ``forward``;
* the ``ServeEngine`` with an image per request: greedy tokens identical
  to the JAX engine's, fused at chunk 1 and 4 and legacy; a prompt
  filling ``max_seq``; a request with extras on an engine with
  ``prefill_chunk_tokens > 0`` (it prefills whole, also on a dense
  model); two images giving two streams; sessions migrated in process
  and over the wire both ways, in float32 and bfloat16; ``encode_session``
  bytes identical with ``image_embeds``;
* checkpoint files byte-identical at ``nb = 2``, and ``params_to_numpy``
  inverting ``params_from_numpy``.

The cross layers' gates are zero at init, and ``tanh(0) = 0`` would hide
any fault of the cross path: every test sets them nonzero (a different
pair in each superblock) in the numpy tree before converting it to both
packages.  Float32 on both sides unless a test says bfloat16; tokens and
bytes are exact, the tolerances (1e-4 on logits, 1e-5 on caches and
single layers) cover summation order only.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config
from repro.models import get_model
from repro.models import layers as JL
from repro.models import sessions as jsessions
from repro.region import wire as jwire
from repro.serve import Request, ServeEngine
from repro_torch.checkpoint import store as tstore
from repro_torch.configs import get_config as tget_config
from repro_torch.models import get_model as tget_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.region import wire as twire
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import Session as TSession

ARCH = "llama-3.2-vision-90b"
MAX_SEQ = 32
LEAVES = ("k_self", "v_self", "k_cross", "v_cross")
GATES = {"gate_attn": [0.7, 0.5], "gate_mlp": [-0.4, 0.3]}   # per superblock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch=ARCH, dtype=None):
    jc, tc = get_config(arch, reduced=True), tget_config(arch, reduced=True)
    if dtype is not None:
        jc = dataclasses.replace(jc, compute_dtype=dtype)
        tc = dataclasses.replace(tc, compute_dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module")
def pair():
    """Per (arch, compute dtype): the reference (model, params) and the
    port's, same weights, the vlm gates nonzero; built once per module."""
    cache = {}

    def get(dtype=None, arch=ARCH):
        key = (arch, dtype)
        if key not in cache:
            jc, tc = _configs(arch, dtype)
            jm = get_model(jc)
            params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, params)
            if jc.family == "vlm":
                for name, vals in GATES.items():
                    tree["cross_layers"][name] = np.asarray(vals, np.float32)
                params = jax.tree.map(jnp.asarray, tree)
            tp = params_from_numpy(tc, tree, "cpu")
            cache[key] = (jm, params, tget_model(tc), tp)
        return cache[key]
    return get


def _image(cfg, seed=7):
    """An image as ``tests/test_decode_fast_path.py`` makes one."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (cfg.n_image_tokens, cfg.d_model)))


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

def test_cross_attention_prefill_and_decode_match_jax():
    jc, tc = _configs()
    jp = jax.tree.map(np.asarray, JL.attention_init(
        jc, jax.random.PRNGKey(3), cross=True)[0])
    tp = TL.Attention(tc, {n: torch.tensor(a) for n, a in jp.items()})
    rng = np.random.default_rng(0)
    B, S = 2, 6
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    img = rng.standard_normal((B, jc.n_image_tokens, jc.d_model)).astype(
        np.float32)
    want = JL.attention_apply(jc, jp, jnp.asarray(x),
                              positions=jnp.arange(S),
                              kv_src=jnp.asarray(img))
    out, k, v = TL.attention_apply(tc, tp, torch.from_numpy(x),
                                   positions=torch.arange(S),
                                   kv_src=torch.from_numpy(img))
    _close(out, want.x, 1e-5)
    _close(k, want.k, 1e-5)
    _close(v, want.v, 1e-5)
    assert k.shape == (B, jc.n_image_tokens, jc.n_kv_heads, jc.hd)
    # one token against the static cross cache, positions ragged (the
    # cross query takes no RoPE, so they must not matter)
    x1 = x[:, :1]
    pos = jnp.asarray([[3], [11]])
    want = JL.attention_apply(jc, jp, jnp.asarray(x1), mode="decode",
                              positions=pos, kv_src=jnp.asarray(x1),
                              k_cache=want.k, v_cache=want.v)
    got = TL.attention_cross_decode(tc, tp, torch.from_numpy(x1), k, v)
    _close(got, want.x, 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_prefill_and_decode_logits_and_caches_match_jax(pair):
    jm, params, tm, tp = pair()
    assert len(tp.blocks) == 2 and len(tp.blocks[0].self_layers) == 4
    assert tm.prefill_chunk is None            # the vlm prefills whole
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in (5, 19)]
    images = [_image(tm.cfg, 7), _image(tm.cfg, 8)]
    B = 2
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_spec(B, MAX_SEQ))
    tcache = {n: torch.zeros(shape, dtype=dt)
              for n, (shape, dt) in tm.cache_spec(B, MAX_SEQ).items()}
    assert {n: tuple(t.shape) for n, t in tcache.items()} == {
        n: s.shape for n, s in jcache.items()}
    nxt = []
    for slot, (prompt, img) in enumerate(zip(prompts, images)):
        jl, jpc = jax.jit(jm.prefill)(
            params, {"tokens": jnp.asarray(prompt)[None],
                     "image_embeds": jnp.asarray(img)[None]})
        tl, tpc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None],
                                  "image_embeds": torch.from_numpy(img)[None]})
        _close(tl, jl)
        for name in LEAVES:
            assert tpc[name].shape == jpc[name].shape, name
            _close(tpc[name], jpc[name], 1e-5)
        jcache = jsessions.insert_session(jcache, slot, jpc,
                                          jm.cache_logical_axes())
        tm.insert_session(tcache, slot, tpc)
        nxt.append(int(np.argmax(np.asarray(jl)[0, -1])))
    ptrs = {n: t.data_ptr() for n, t in tcache.items()}
    cross = {n: tcache[n].clone() for n in ("k_cross", "v_cross")}
    tok = np.asarray(nxt, np.int32)[:, None]
    pos = np.asarray([len(p) for p in prompts], np.int32)     # ragged
    for _ in range(3):
        jl, jcache = jm.decode_jit(params, jnp.asarray(tok), jnp.asarray(pos),
                                   jcache)
        tl, tcache2 = tm.decode(tp, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos), tcache)
        assert tcache2 is tcache
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1
    assert {n: t.data_ptr() for n, t in tcache.items()} == ptrs
    for name in LEAVES:
        _close(tcache[name], jcache[name], 1e-5)
    for name, before in cross.items():           # never written by decode
        assert torch.equal(tcache[name], before), name


def test_prefill_and_decode_match_forward(pair):
    """Greedy decode after a prefill gives, at every step, the logits the
    port's own full-sequence ``forward`` gives at that position; and that
    ``forward`` is the JAX package's."""
    jm, params, tm, tp = pair()
    prompt = np.random.default_rng(5).integers(0, tm.cfg.vocab, 7)
    img = torch.from_numpy(_image(tm.cfg))[None]
    logits, pc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None],
                                 "image_embeds": img})
    cache = {n: torch.zeros(shape, dtype=dt)
             for n, (shape, dt) in tm.cache_spec(1, MAX_SEQ).items()}
    tm.insert_session(cache, 0, pc)
    steps = [logits[0, -1]]
    seq = list(prompt)
    for i in range(4):
        seq.append(int(torch.argmax(steps[-1])))
        logits, _ = tm.decode(tp, torch.tensor([[seq[-1]]]),
                              torch.tensor([len(prompt) + i]), cache)
        steps.append(logits[0, -1])
    full = tm.forward(tp, {"tokens": torch.tensor(seq)[None],
                           "image_embeds": img})
    assert full.shape == (1, len(seq), tm.cfg.vocab)
    for i, row in enumerate(steps):
        _close(row, full[0, len(prompt) - 1 + i])
    jfull = jax.jit(jm.forward)(params, {
        "tokens": jnp.asarray(seq)[None], "image_embeds": jnp.asarray(img)})
    _close(full, jfull)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(vocab, length, n, seed=0):
    return [np.random.default_rng(seed + s).integers(0, vocab, length)
            for s in range(n)]


def _run(engine_cls, req_cls, model, params, prompts, max_new, images,
         **kw):
    engine = engine_cls(model, params, max_batch=2, max_seq=MAX_SEQ, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new=max_new,
                    extras={"image_embeds": img})
            for i, (p, img) in enumerate(zip(prompts, images))]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained(max_steps=500)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs], engine


@pytest.mark.parametrize("fused,chunk,kw", [
    (True, 1, {}), (True, 4, {}), (False, 1, {}),
    (True, 2, {"prefill_chunk_tokens": 4})])     # prefills whole anyway
def test_engine_token_identity_with_jax(pair, fused, chunk, kw):
    jm, params, tm, tp = pair()
    prompts = _prompts(tm.cfg.vocab, 6, 3)          # 3 requests, 2 slots
    images = [_image(tm.cfg)] * 3
    want, jeng = _run(ServeEngine, Request, jm, params, prompts, 6, images,
                      fused=fused, decode_chunk=chunk, **kw)
    got, teng = _run(TServeEngine, TRequest, tm, tp, prompts, 6, images,
                     fused=fused, decode_chunk=chunk, **kw)
    assert got == want, (fused, chunk, got, want)
    assert all(len(t) == 6 for t in got)
    assert teng.scheduler.ptt.updates == jeng.scheduler.ptt.updates
    assert not teng._chunking()


@pytest.mark.parametrize("plen", [MAX_SEQ, MAX_SEQ - 1])
def test_prompt_filling_the_cache_matches_jax(pair, plen):
    """A prompt of ``max_seq`` tokens decodes its first token at ``pos ==
    max_seq``, whose self-layer K/V write the reference drops; the cross
    cache is read whole either way.  ``max_seq - 1`` is the control."""
    jm, params, tm, tp = pair()
    prompts = _prompts(tm.cfg.vocab, plen, 3, seed=100)
    images = [_image(tm.cfg, s) for s in (7, 8, 9)]
    want, _ = _run(ServeEngine, Request, jm, params, prompts, 4, images,
                   decode_chunk=4)
    got, _ = _run(TServeEngine, TRequest, tm, tp, prompts, 4, images,
                  decode_chunk=4)
    assert got == want, (plen, got, want)


def test_request_with_extras_prefills_whole_on_a_chunking_dense_engine(
        pair):
    """A dense engine with ``prefill_chunk_tokens > 0`` chunks plain
    prompts, but a request with extras takes the whole-prompt path, as the
    reference's does (its prefill ignores the image)."""
    jm, params, tm, tp = pair(arch="qwen2-0.5b")
    assert tm.prefill_chunk is not None
    prompts = _prompts(tm.cfg.vocab, 10, 3, seed=50)
    img = np.zeros((4, tm.cfg.d_model), np.float32)

    def run(engine_cls, req_cls, model, prm):
        eng = engine_cls(model, prm, max_batch=2, max_seq=MAX_SEQ,
                         decode_chunk=2, prefill_chunk_tokens=4)
        reqs = [req_cls(rid=i, prompt=p.copy(), max_new=5,
                        extras={"image_embeds": img} if i != 1 else {})
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.step()
        chunked = [pf.req.rid for pf in eng.prefilling]
        eng.run_until_drained(max_steps=200)
        return [list(r.out_tokens) for r in reqs], chunked

    want, jchunked = run(ServeEngine, Request, jm, params)
    got, tchunked = run(TServeEngine, TRequest, tm, tp)
    assert got == want
    assert tchunked == jchunked == [1]      # only the plain prompt chunks


def test_two_images_give_two_streams_in_both_packages(pair):
    jm, params, tm, tp = pair()
    prompt = _prompts(tm.cfg.vocab, 6, 1, seed=3)[0]
    streams = {}
    for seed in (7, 8):
        images = [_image(tm.cfg, seed)]
        streams[seed] = (
            _run(ServeEngine, Request, jm, params, [prompt], 8, images)[0],
            _run(TServeEngine, TRequest, tm, tp, [prompt], 8, images)[0])
        assert streams[seed][0] == streams[seed][1], seed
    assert streams[7][1] != streams[8][1]


def _engines(entry, kinds):
    jm, params, tm, tp = entry

    def engine(kind):
        if kind == "jax":
            return ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                               decode_chunk=2), Request
        return TServeEngine(tm, tp, max_batch=2, max_seq=MAX_SEQ,
                            decode_chunk=2), TRequest
    return [engine(k) for k in kinds]


def _unmigrated(engine, req_cls, prompt, img):
    r = req_cls(rid=0, prompt=prompt.copy(), max_new=8,
                extras={"image_embeds": img})
    engine.submit(r)
    engine.run_until_drained(max_steps=100)
    return list(r.out_tokens)


def _migrated(src, src_req, dst, prompt, img, how, to_jax=False):
    """Prefill and one chunk of 2 on ``src``, then the session in process
    (its bits intact: a port session's ``uint16`` leaves viewed as
    ``ml_dtypes`` bfloat16 for the JAX engine) or as wire bytes to
    ``dst``, and on to the end there; returns the moved request's
    tokens."""
    req = src_req(rid=0, prompt=prompt.copy(), max_new=8, tenant=7,
                  extras={"image_embeds": img})
    src.submit(req)
    src.step()
    assert not req.done
    if how == "wire":
        dst.import_session_wire(src.export_session_wire(0))
        sess = dst.sessions_in[-1]
        assert sess.req.tenant == 7
        np.testing.assert_array_equal(sess.req.extras["image_embeds"], img)
        req = sess.req
    else:
        sess = src.export_session(0)
        if to_jax:
            sess.cache = {n: (a.view(ml_dtypes.bfloat16)
                              if a.dtype == np.uint16 else a)
                          for n, a in sess.cache.items()}
        dst.import_session(sess)
    # the cross leaves travel whole, the self leaves to the position
    assert sess.cache["k_cross"].shape[2] == src.model.cfg.n_image_tokens
    assert sess.cache["k_self"].shape[3] == sess.pos
    dst.run_until_drained(max_steps=100)
    assert req.done and req.rid == 0
    return list(req.out_tokens)


@pytest.mark.parametrize("src,dst,how", [
    ("port", "port", "in-process"), ("port", "port", "wire"),
    ("jax", "port", "wire"), ("port", "jax", "wire")])
def test_migration_token_identity(pair, src, dst, how):
    """A session exported after one decode chunk continues the unmigrated
    JAX stream."""
    entry = pair()
    prompt = _prompts(entry[2].cfg.vocab, 6, 1, seed=7)[0]
    img = _image(entry[2].cfg)
    (j, jreq), = _engines(entry, ["jax"])
    want = _unmigrated(j, jreq, prompt, img)
    (a, req_cls), (b, _) = _engines(entry, [src, dst])
    got = _migrated(a, req_cls, b, prompt, img, how)
    assert got == want, (src, dst, how, got, want)


@pytest.mark.parametrize("direction", ("jax->port", "port->jax"))
def test_bf16_sessions_cross_the_packages_over_the_wire(pair, direction):
    """bfloat16: all four cache leaves travel as ``"bfloat16"`` bits.  Over
    the wire the destination resumes exactly as from the session handed
    over in process with its bits intact, and that is the unmigrated
    stream, on which the two packages agree for this prompt."""
    entry = pair("bfloat16")
    prompt = _prompts(entry[2].cfg.vocab, 6, 1, seed=7)[0]
    img = _image(entry[2].cfg)
    src, dst = direction.split("->")
    (a, req_cls), (b, _) = _engines(entry, [src, dst])
    got = _migrated(a, req_cls, b, prompt, img, "wire")
    (a, req_cls), (b, _) = _engines(entry, [src, dst])
    assert got == _migrated(a, req_cls, b, prompt, img, "in-process",
                            to_jax=dst == "jax")
    (s, s_req), (d, d_req) = _engines(entry, [src, dst])
    want = _unmigrated(s, s_req, prompt, img)
    assert want == _unmigrated(d, d_req, prompt, img)   # they agree here
    assert got == want, (direction, got, want)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_encode_session_bytes_identical_with_image_embeds(pair, dtype):
    """A live vlm session the JAX engine exported (its four cache leaves,
    the image in ``extras``) and the same session in the port's types
    encode to the same bytes; each package decodes the other's."""
    jm, params, _, _ = pair(None if dtype == "float32" else dtype)
    eng = ServeEngine(jm, params, max_batch=2, max_seq=MAX_SEQ,
                      decode_chunk=2)
    req = Request(rid=3, prompt=_prompts(jm.cfg.vocab, 6, 1)[0], max_new=8,
                  extras={"image_embeds": _image(jm.cfg)})
    eng.submit(req)
    eng.step()
    js = eng.export_session(3)
    js.req.t_first, js.req.t_admit = 1.25, 1.0
    bits = {n: (np.asarray(a).view(np.uint16) if a.dtype == ml_dtypes.bfloat16
                else np.asarray(a).copy()) for n, a in js.cache.items()}
    tr = TRequest(**{f.name: getattr(js.req, f.name)
                     for f in dataclasses.fields(TRequest)})
    ts = TSession(req=tr, pos=js.pos, cur_token=js.cur_token, cache=bits)
    jb = jwire.encode_session(js, codec="zlib")
    tb = twire.encode_session(ts, codec="zlib")
    assert tb == jb
    back = twire.decode_session(jb)
    np.testing.assert_array_equal(back.req.extras["image_embeds"],
                                  js.req.extras["image_embeds"])
    for n, a in bits.items():
        assert back.cache[n].dtype == a.dtype
        np.testing.assert_array_equal(back.cache[n], a)
    assert jwire.decode_session(tb).pos == js.pos


# ---------------------------------------------------------------------------
# checkpoints and conversion
# ---------------------------------------------------------------------------

def _files(step_dir):
    return {name: open(os.path.join(step_dir, name), "rb").read()
            for name in sorted(os.listdir(step_dir))}


def test_checkpoint_byte_identical_and_cross_loading(pair, tmp_path):
    """The reference's tree written by the JAX package and the same
    parameters written by the port from its modules give the same files
    (two superblocks: a swapped ``(b, i)`` shows); the port reads the JAX
    package's back into the same modules, and the JAX model's logits on
    the port's checkpoint are the port's."""
    jm, params, tm, tp = pair()
    jd = jstore.save_checkpoint(str(tmp_path / "jax"), 4, params)
    td = tstore.save_checkpoint(str(tmp_path / "port"), 4,
                                params_to_numpy(tm.cfg, tp))
    jf, tf = _files(jd), _files(td)
    assert tf.keys() == jf.keys()
    for name in jf:
        assert tf[name] == jf[name], name
    tree, _ = tstore.load_checkpoint(str(tmp_path / "jax"), 4,
                                     params_to_numpy(tm.cfg, tp),
                                     device="cpu")
    tp2 = params_from_numpy(tm.cfg, tree, "cpu")
    mine, back = dict(tp.named_parameters()), dict(tp2.named_parameters())
    assert mine.keys() == back.keys()
    for n, a in mine.items():
        assert torch.equal(a, back[n]), n
    jparams, _ = jstore.load_checkpoint(str(tmp_path / "port"), 4, params)
    tokens = np.random.default_rng(1).integers(0, tm.cfg.vocab, (1, 9))
    img = _image(tm.cfg)[None]
    jl, _ = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(tokens),
                                          "image_embeds": jnp.asarray(img)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                            "image_embeds": torch.from_numpy(img)})
    _close(tl, jl, 1e-5)


def test_params_to_numpy_inverts_params_from_numpy(pair):
    _, params, tm, tp = pair()
    tree = jax.tree.map(np.asarray, params)
    assert tree["self_layers"]["attn"]["wq"].shape[:2] == (2, 4)
    assert tree["cross_layers"]["gate_attn"].shape == (2,)
    back = params_to_numpy(tm.cfg, params_from_numpy(tm.cfg, tree, "cpu"))
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32, path
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert [float(sb.cross.gate_mlp) for sb in tp.blocks] == pytest.approx(
        GATES["gate_mlp"])
