"""The port's dense layers sharded over the mesh (``repro_torch.distributed.
tp``) on gloo ranks, held against the JAX package's unsharded functions
and against the port's own unsharded run.

Reduced qwen2-0.5b (14/2 heads: whole heads on 2 ranks of ``model``, a
fallback to whole heads on 4) and smollm-135m (9/3 heads: the fallback on
every mesh), two layers, float32, the reference's ``init`` carried over
and sliced per rank (``convert.local_tree``), on (data, model) = (1, 2),
(2, 2) and (1, 4).  One gloo launch a mesh runs both models:

* the prefill's logits of 4 x 16 prompts within 1e-4 abs and rel of the
  reference's ``prefill`` and 1e-5 of the port's unsharded prefill;
* 16 greedy tokens from decode steps starting at positions 3, 9, 16 and
  12 (each slot's prompt token there fed first) over the prefill's cache
  in a 16-row cache, sharded along ``Smax`` over ``model``: positions in
  different shards, and one slot whose prompt fills the cache (C1: its
  writes dropped, every row read), token for token the reference's
  ``decode_fused``; under the analysis audit's recorder the fused decode
  reads nothing on the host and keeps its cache's ``data_ptr``s;
* one AdamW step (the reference's ``make_train_step``): the loss within
  1e-4, every updated parameter, gathered whole, within 2e-4 abs and rel
  (``tests/test_torch_train.py``'s limits); for qwen2 also with
  ``microbatches=2`` (each rank splitting its own rows) and with
  ``compress_dcn`` (each block scaled by its whole leaf's max), each
  against the reference's step with the same option;
* chunked prefill (``CHUNKS``): chunks of 8 into a 16-row cache sharded
  along ``Smax``, with a chunk that crosses a shard boundary, padded rows,
  ``qlen`` 0 and a chunk past the cache's end (C2): every call's logits
  within 1e-4 of the reference's ``prefill_chunk`` on the same chunks, and
  the greedy decode stream after them token for token;
* the collectives of one training forward by kind and mesh axis, pinned
  to the Megatron sequence-parallel count (see ``_expected_forward``).

The other families, serving only, in the same launches (``SERVE``), each
held against the reference's unsharded functions on its weights:

* reduced granite-moe (8 experts, top 2): the prefill of 4 x 16 prompts
  (the tokens gathered whole and each rank's experts summed over
  ``model``) within 1e-4 and the 16-token decode stream as above, token
  for token; and a prefill of 2 x 2064 prompts, above the reference's
  4096-token threshold, which runs ``moe_ep_local`` on each rank's block
  (two ``all_to_all_single`` a layer, counted), within 1e-4.  That one
  runs at capacity factor 16, where no copy drops, so the blocks'
  capacities give the unsharded result; at factor 1.0 copies drop and
  ``tests/test_torch_moe_ep.py`` holds the same body (``moe_ep``) against
  the reference's ``moe_ep`` on a mesh of the same shape;
* reduced jamba (one attention layer, seven SSM layers, MoE every second
  layer): prefill and decode stream, the SSD of each SSM layer on the
  rank's block of its 8 heads, the conv state's channels on ``model``;
* reduced mamba2: prefill and decode stream, and one AdamW step (the
  reference's gradient taken with its SSD's masked ``exp`` clamped, as in
  ``tests/test_torch_forward.py``), the SSD on the rank's heads; and at
  ``d_model`` 48 (6 heads), whose SSD falls back to whole heads on 4
  ranks of ``model`` (recorded) and splits on 2;
* reduced llama-3.2-vision with 8 image tokens (so the cross cache's rows
  shard over ``model`` and the cross decode merges the ranks' results by
  log-sum-exp) and its cross gates nonzero: prefill and decode stream;
* reduced hubert with its biases nonzero: ``forward``'s logits of the
  rank's frames (its head column-parallel, exchanged all-to-all) against
  the same frames of the reference's ``forward``.

The launcher writes a checkpoint from each mesh; the one from (2, 2),
read by the reference's ``load_checkpoint``, holds the state the (2, 2)
ranks gathered, and each mesh resumes it through the launcher: the state
it resumed, gathered whole, equals every leaf, and one more step's loss
is the unsharded run's.

The reference walker's collectives on the same cell (reduced qwen2 on a
(data 2, model 2) mesh of fake XLA devices) are in ``CHANGES.md``: GSPMD
does not follow a Megatron schedule, so the two are not held equal.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro.checkpoint import load_checkpoint
from repro.configs import get_config
from repro.models import get_model
from repro.models import mamba2 as jmamba2
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.train.step import make_train_step as jmake_train_step
from repro.train.step import train_state_init as jtrain_state_init
from repro_torch.configs import get_config as tget_config
from repro_torch.distributed.ranks import run_ranks
from repro_torch.kernels.ragged_decode import ops as rd
from repro_torch.kernels.ragged_prefill import ops as rp
from repro_torch.models import get_model as tget_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_leaves

ARCHS = ("qwen2-0.5b", "smollm-135m")
MESHES = ((1, 2), (2, 2), (1, 4))
B, S, SMAX, NEW = 4, 16, 16, 16
LENS = (3, 9, 16, 12)
TRAIN = (4, 8)
OPT = dict(lr=5e-3, warmup_steps=3, total_steps=50)
TOL, PARAM_TOL = 1e-4, 2e-4
# the chunked prefill: each slot's prompt length, and each call's
# per-slot (start, live rows) in chunks of T=8 into a 16-row cache: slot 0
# fills the cache, slot 1 ends in padded rows, slot 2's second chunk
# crosses row 8 (a shard boundary on 2 and 4 ranks), slot 3's third chunk
# lies past the cache's end (C2); slots 0-2 take qlen 0 in the third call
CHUNK_T = 8
CHUNK_LENS = (16, 13, 12, 22)
CHUNK_CALLS = (((0, 8), (0, 8), (0, 4), (0, 8)),
               ((8, 8), (8, 5), (4, 8), (8, 8)),
               ((16, 0), (13, 0), (12, 0), (16, 6)))
# the train step's options held against the reference's, on qwen2
TRAIN_OPTIONS = {"microbatches": {"microbatches": 2},
                 "compress_dcn": {"compress_dcn": True}}
# label -> (arch, configuration changes, prompts (B, S), what runs)
SERVE = {
    "granite": ("granite-moe-1b-a400m", {}, (B, S), "decode"),
    "granite-ep": ("granite-moe-1b-a400m", {"capacity_factor": 16.0},
                   (2, 2064), "prefill"),
    "jamba": ("jamba-v0.1-52b", {}, (B, S), "decode"),
    "vlm": ("llama-3.2-vision-90b", {"n_image_tokens": 8}, (B, S),
            "decode"),
    "hubert": ("hubert-xlarge", {}, (B, S), "forward"),
    "mamba2": ("mamba2-130m", {}, (B, S), "train"),
    "mamba2-6h": ("mamba2-130m", {"d_model": 48}, (B, S), "prefill"),
}
VLM_GATES = {"gate_attn": [0.7, 0.5], "gate_mlp": [-0.4, 0.3]}
AUDIO_BIASES = (("layers", "attn", "bq"), ("layers", "attn", "bk"),
                ("layers", "attn", "bv"), ("layers", "ln1", "bias"),
                ("layers", "ln2", "bias"), ("layers", "mlp", "b_in"),
                ("layers", "mlp", "b_out"), ("ln_f", "bias"))


def _chunks(rng, vocab) -> dict:
    """``CHUNK_CALLS`` as inputs: each call's (B, T) tokens (a padded row
    holds a prompt's later token or 0: it must reach nothing), starts and
    live rows, and the token and position each slot decodes from."""
    P = rng.integers(1, vocab, (B, max(CHUNK_LENS) + 1)).astype(np.int32)
    out = {"tokens": [], "start": [], "qlen": []}
    for call in CHUNK_CALLS:
        start = np.asarray([c[0] for c in call], np.int32)
        tok = np.zeros((B, CHUNK_T), np.int32)
        for b, s0 in enumerate(start):
            n = min(CHUNK_T, P.shape[1] - s0)
            tok[b, :n] = P[b, s0:s0 + n]
        out["tokens"].append(tok)
        out["start"].append(start)
        out["qlen"].append(np.asarray([c[1] for c in call], np.int32))
    lens = np.asarray(CHUNK_LENS, np.int32)
    out["next"], out["pos"] = P[np.arange(B), lens], lens
    return out


def _chunked_reference(jm, params, chunks):
    """Every call's logits of the reference's ``prefill_chunk`` over a zero
    (B, 16) cache, and the decode stream after them."""
    cache = {n: jnp.zeros(sd.shape, sd.dtype)
             for n, sd in jm.cache_spec(B, SMAX).items()}
    logits = []
    for tok, start, qlen in zip(chunks["tokens"], chunks["start"],
                                chunks["qlen"]):
        out, cache = jm.prefill_chunk(params, jnp.asarray(tok), cache,
                                      jnp.asarray(start), jnp.asarray(qlen))
        logits.append(np.asarray(out))
    stream = jm.decode_fused(params, jnp.asarray(chunks["next"])[:, None],
                             jnp.asarray(chunks["pos"]), cache, NEW)[0]
    return np.stack(logits), np.asarray(stream)


def _train_reference(jm, params, train, clamp=False, **options):
    """The reference's updated parameters and loss after one AdamW step
    with ``options``; with ``clamp`` its SSD's ``exp`` clamped, so that its
    gradient is finite (``tests/test_torch_forward.py``)."""
    opt = JAdamWConfig(**OPT)
    state = {"params": params, "opt": jadamw_init(params)}
    if options.get("compress_dcn"):
        state["ef"] = jax.tree.map(jnp.zeros_like, params)
    batch = {k: jnp.asarray(v) for k, v in train.items()}
    with pytest.MonkeyPatch.context() as mp:
        if clamp:
            mp.setattr(jmamba2, "jnp", _ClampedExp())
        new, metrics = jax.jit(jmake_train_step(jm, opt, **options))(
            state, batch)
    return (float(metrics["loss"]),
            jax.tree.map(np.asarray, new["params"]))


class _ClampedExp:
    """``jax.numpy`` with ``exp``'s argument clamped at 80: the SSD's
    exponents are <= 0 but for the entries its mask drops after the
    ``exp``, so the forward is unchanged and the gradient finite."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jnp.exp(jnp.minimum(x, 80.0))


def _reference(arch, seed):
    cfg = get_config(arch, reduced=True)
    jm = get_model(cfg)
    params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    train = {k: rng.integers(0, cfg.vocab, TRAIN).astype(np.int32)
             for k in ("tokens", "labels")}
    chunks = _chunks(rng, cfg.vocab)
    logits, cache = jax.jit(jm.prefill)(params, {"tokens": tokens})
    lens = np.asarray(LENS, np.int32)
    tok = tokens[np.arange(B), np.minimum(lens, S - 1)][:, None]
    stream = jm.decode_fused(params, jnp.asarray(tok), jnp.asarray(lens),
                             cache, NEW)[0]
    loss, new = _train_reference(jm, params, train)
    tm = tget_model(tget_config(arch, reduced=True))
    with torch.no_grad():
        port = tm.prefill(params_from_numpy(tm.cfg, tree, "cpu"),
                          {"tokens": torch.from_numpy(tokens).long()})[0]
    out = {"tree": tree, "tokens": tokens, "train": train,
           "prefill": np.asarray(logits), "port_prefill": port.numpy(),
           "stream": np.asarray(stream), "loss": loss, "params": new,
           "chunks": chunks}
    out["chunk_logits"], out["chunk_stream"] = _chunked_reference(
        jm, params, chunks)
    if arch == ARCHS[0]:
        for label, kw in TRAIN_OPTIONS.items():
            out[label] = _train_reference(jm, params, train, **kw)
    return out


def _serve_reference(label, seed):
    """The reference's unsharded results on one of ``SERVE``: its weights
    (vlm gates and audio biases drawn nonzero: zero at init would hide
    their paths), the batch, and the prefill's logits and decode stream,
    or ``forward``'s logits."""
    arch, over, (b, s), mode = SERVE[label]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
    jm = get_model(cfg)
    params = jax.jit(lambda k: jm.init(k)[0])(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.array, params)
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        for name, vals in VLM_GATES.items():
            tree["cross_layers"][name] = np.asarray(vals, np.float32)
    if cfg.family == "audio":
        for path in AUDIO_BIASES:
            d = tree
            for key in path[:-1]:
                d = d[key]
            d[path[-1]] = 0.3 * rng.standard_normal(
                d[path[-1]].shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    if cfg.family == "audio":
        batch = {"frames": rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(
            np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    out = {"tree": tree, "batch": batch, "train": None}
    if mode == "train":
        out["train"] = {k: rng.integers(0, cfg.vocab, TRAIN).astype(np.int32)
                        for k in ("tokens", "labels")}
        out["loss"], out["params"] = _train_reference(
            jm, params, out["train"], clamp=True)
    if mode == "forward":
        out["forward"] = np.asarray(jax.jit(jm.forward)(params, batch))
        return out
    logits, cache = jax.jit(jm.prefill)(params, batch)
    out["prefill"] = np.asarray(logits)
    if mode in ("decode", "train"):
        lens = np.asarray(LENS, np.int32)
        tok = batch["tokens"][np.arange(b), np.minimum(lens, s - 1)][:, None]
        out["stream"] = np.asarray(jm.decode_fused(
            params, jnp.asarray(tok), jnp.asarray(lens), cache, NEW)[0])
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's results, the models compiled side by side."""
    jobs = [(_reference, arch, i) for i, arch in enumerate(ARCHS)]
    jobs += [(_serve_reference, label, len(ARCHS) + i)
             for i, label in enumerate(SERVE)]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        done = [pool.submit(*job) for job in jobs]
        return {job[1]: f.result() for job, f in zip(jobs, done)}


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def sharded(reference, ckpt_root):
    """Every rank's results on each mesh, every model in one launch, the
    three meshes' launches side by side."""
    cases = [(a, reference[a]["tree"], reference[a]["tokens"], LENS,
              reference[a]["train"], reference[a]["chunks"]) for a in ARCHS]
    serve = {label: (arch, over, mode, reference[label]["tree"],
                     reference[label]["batch"], LENS,
                     reference[label]["train"])
             for label, (arch, over, _, mode) in SERVE.items()}

    def launch(shape):
        return run_ranks(ranks.sharded_body, shape[0] * shape[1], shape,
                         cases, serve, SMAX, NEW, OPT, TRAIN_OPTIONS,
                         ckpt_root, device="cpu", timeout=400)
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        return dict(zip(MESHES, pool.map(launch, MESHES)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_unsharded(arch, shape, reference, sharded):
    ref = reference[arch]
    for out in sharded[shape]:
        _close(out[arch]["prefill"], ref["prefill"], TOL)
        _close(out[arch]["prefill"], ref["port_prefill"], 1e-5)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("label", SERVE)
def test_other_family_matches_reference(label, shape, reference, sharded):
    """Prefill logits (or ``forward``'s, the rank's frames) within 1e-4 of
    the reference's unsharded functions, and the decode stream token for
    token, with no host read in the decode and its cache in place."""
    ref = reference[label]
    for out in sharded[shape]:
        got = out[label]
        if "forward" in ref:
            V = ref["forward"].shape[-1]
            want = ref["forward"].reshape(-1, V)[got["index"].reshape(-1)]
            _close(got["forward"].reshape(-1, V), want, TOL)
            continue
        _close(got["prefill"], ref["prefill"], TOL)
        if "stream" in ref:
            np.testing.assert_array_equal(got["stream"], ref["stream"])
            assert got["ptrs_kept"] and got["decode_findings"] == []
        if "loss" in ref:
            assert got["loss"] == pytest.approx(ref["loss"], rel=TOL,
                                                abs=TOL)
            for a, b in zip(tree_leaves(got["params"]),
                            tree_leaves(ref["params"])):
                _close(a, b, PARAM_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_moe_paths_taken(shape, sharded):
    """The granite prefill above 4096 tokens runs expert-parallel on each
    rank's block (two ``all_to_all_single`` a layer); the 64-token prefill
    and the decode gather the tokens (none).  The SSD runs on each rank's
    block of heads where ``heads`` divides ``model`` (jamba's and mamba2's
    8 heads on 2 and 4 ranks, 6 heads on 2), so ``ssm`` is not recorded as
    computed whole; where it does not divide (6 heads on 4 ranks) it is."""
    L = tget_config("granite-moe-1b-a400m", reduced=True).n_layers
    for out in sharded[shape]:
        assert out["granite-ep"]["a2a"] == 2 * L
        assert out["granite"]["a2a"] == 0
        assert "ssm" not in out["jamba"]["replicated"]
        assert "ssm" not in out["mamba2"]["replicated"]
        assert ("ssm" in out["mamba2-6h"]["replicated"]) == (6 % shape[1]
                                                              != 0)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_stream_matches_reference(arch, shape, reference, sharded):
    for out in sharded[shape]:
        np.testing.assert_array_equal(out[arch]["stream"],
                                      reference[arch]["stream"])
        assert out[arch]["ptrs_kept"]
        # no host sync, float64 or moved cache leaf inside the fused decode
        # (the caller copies the (B, k) ids home once a chunk)
        assert out[arch]["decode_findings"] == []


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_reference(arch, shape, reference, sharded):
    """``prefill_chunk`` over the cache sharded along ``Smax`` (each call's
    logits within 1e-4 of the reference's on the same chunks), then the
    greedy decode stream token for token, with no host read and the cache
    in place."""
    ref = reference[arch]
    for out in sharded[shape]:
        got = out[arch]["chunked"]
        _close(got["logits"], ref["chunk_logits"], TOL)
        np.testing.assert_array_equal(got["stream"], ref["chunk_stream"])
        assert got["ptrs_kept"] and got["decode_findings"] == []


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("option", TRAIN_OPTIONS)
def test_train_option_matches_reference(option, shape, reference, sharded):
    """qwen2's AdamW step with ``microbatches=2`` or ``compress_dcn``
    against the reference's step with the same option."""
    loss, params = reference[ARCHS[0]][option]
    for out in sharded[shape]:
        got = out[ARCHS[0]][option]
        assert got["loss"] == pytest.approx(loss, rel=TOL, abs=TOL)
        for a, b in zip(tree_leaves(got["params"]), tree_leaves(params)):
            _close(a, b, PARAM_TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, shape, reference, sharded):
    ref = reference[arch]
    for out in sharded[shape]:
        got = out[arch]
        assert got["loss"] == pytest.approx(ref["loss"], rel=TOL, abs=TOL)
        for a, b in zip(tree_leaves(got["params"]),
                        tree_leaves(ref["params"])):
            _close(a, b, PARAM_TOL)


def _expected_forward(arch, shape):
    """The training forward's collectives on a (data, model) mesh: a
    layer all-gathers the sequence into attention and into the MLP and
    reduce-scatters each out (2 + 2 over ``model``), and all-gathers its
    7 weights' FSDP shards over ``data`` (``wq``, ``wk``, ``wv``, ``wo``,
    ``w_gate``, ``w_up``, ``w_down``; at ``data`` 1 too, a group of one);
    where the query heads do not divide ``model`` (qwen2's 14 on 4,
    smollm's 9), the q, k and v columns are gathered to whole heads (3
    more over ``model``).  Besides: the embedding's FSDP gather and its
    vocab-parallel partial sums reduce-scattered onto the sequence; the
    tied head's FSDP gather, the sequence gathered into it and the
    (sequence, vocabulary) blocks exchanged all-to-all."""
    cfg = tget_config(arch, reduced=True)
    L, M = cfg.n_layers, shape[1]
    whole_heads = cfg.n_heads % M != 0
    return {"all-gather@model": (2 + 3 * whole_heads) * L + 1,
            "reduce-scatter@model": 2 * L + 1,
            "all-gather@data": 7 * L + 2,
            "all-to-all@model": 1}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_collectives_pinned(arch, shape, sharded):
    for out in sharded[shape]:
        assert out[arch]["forward_coll"] == _expected_forward(arch, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_train_launcher_on_a_mesh(shape, sharded):
    """``launch.train.run`` with a mesh: the losses of 3 steps of reduced
    smollm as the launcher's without one."""
    from repro_torch.launch import train
    want = train.run(ranks.LAUNCH_ARGS)["losses"]
    for out in sharded[shape]:
        np.testing.assert_allclose(out["launcher"], want, rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def saved_checkpoint(sharded, ckpt_root):
    """The checkpoint the (2, 2) launcher wrote, read by the reference's
    ``load_checkpoint`` into its own train state's structure."""
    jm = get_model(get_config(ranks.LAUNCH_ARGS[3], reduced=True))
    target = jax.eval_shape(lambda k: jtrain_state_init(
        jm, k, JAdamWConfig())[0], jax.random.PRNGKey(0))
    tree, extra = load_checkpoint(ranks.ckpt_dir(ckpt_root, ranks.CKPT_FROM),
                                  3, target)
    assert extra == {"data": {"step": 3}}
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", MESHES)
def test_checkpoint_from_a_mesh(shape, saved_checkpoint, sharded):
    """A checkpoint written from the (2, 2) mesh holds, leaf for leaf, the
    state its ranks gathered, as the reference reads it; the launcher
    resumes it onto every mesh, the (1, 4) one included: the state it
    resumed, gathered whole, equals every leaf, and one more step's loss
    is the unsharded launcher's fourth."""
    from repro_torch.launch import train
    want = tree_leaves(saved_checkpoint)
    fourth = train.run([*ranks.LAUNCH_ARGS[:6], "4",
                        *ranks.LAUNCH_ARGS[7:]])["losses"][3]
    for out in sharded[shape]:
        if shape == ranks.CKPT_FROM:
            got = tree_leaves(out["saved"])
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        got = tree_leaves(out["resumed"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert out["resumed_loss"] == pytest.approx([fourth], rel=TOL,
                                                    abs=TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_backward_on_another_thread(shape, reference, sharded):
    """A training forward under rules whose backward runs on a thread
    with no rules (as autograd's device thread does on the card): the
    recomputed blocks run under the forward's rules, and every rank's
    embedding gradient is there and finite."""
    for out in sharded[shape]:
        g = out["thread_backward"]
        assert g.shape[1] * shape[0] == reference[ARCHS[0]]["tree"]["tok"][
            "embed"].shape[1] and np.isfinite(g).all() and np.abs(g).max() > 0


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_fallbacks_recorded(arch, shape, sharded):
    """The reference's fallback strings for what does not divide: the
    decode step's sequence of 1, and the heads where they do not divide
    ``model``."""
    cfg = tget_config(arch, reduced=True)
    M = shape[1]
    want = {f"seq_sp: dim 1 !% {M} -> replicated"}
    if cfg.n_heads % M:
        want.add(f"heads: dim {cfg.n_heads} !% {M} -> replicated")
    if cfg.n_kv_heads % M:
        want.add(f"kv_heads: dim {cfg.n_kv_heads} !% {M} -> replicated")
    assert set(sharded[shape][0][arch]["fallbacks"]) == want


# ---------------------------------------------------------------------------
# ragged_decode's log-sum-exp, the merge the sharded decode runs
# ---------------------------------------------------------------------------

def _decode_inputs(seed, B=3, Smax=24, Hq=4, Hkv=2, hd=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return f(B, Hq, hd), f(B, Smax, Hkv, hd), f(B, Smax, Hkv, hd)


def test_decode_lse_matches_float64():
    q, k, v = _decode_inputs(0)
    pos = torch.tensor([0, 11, 40], dtype=torch.int32)
    out, lse = rd.ragged_decode_attention(q, k, v, pos, lse=True)
    assert torch.equal(out, rd.ragged_decode_attention(q, k, v, pos))
    qd, kd = q.double().reshape(3, 2, 2, 8), k.double()
    s = torch.einsum("bgrh,bsgh->bgrs", qd, kd) / np.sqrt(8)
    for b, p in enumerate((0, 11, 23)):
        want = torch.logsumexp(s[b, ..., :p + 1], -1).reshape(4)
        np.testing.assert_allclose(lse[b].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-5)


def test_decode_shards_merge_to_the_whole_cache():
    """Three cache shards of 8 rows: a slot whose live rows end before a
    shard gives 0 and -inf there (no NaN), and the merge by log-sum-exp
    equals one call over the whole cache."""
    q, k, v = _decode_inputs(1)
    pos = torch.tensor([2, 13, 23], dtype=torch.int32)
    whole = rd.ragged_decode_attention(q, k, v, pos)
    parts = [rd.ragged_decode_attention(q, k[:, lo:lo + 8], v[:, lo:lo + 8],
                                        pos - lo, lse=True)
             for lo in (0, 8, 16)]
    o, l = parts[2]
    assert torch.equal(o[0], torch.zeros_like(o[0]))
    assert torch.isneginf(l[:2]).all() and torch.isfinite(o).all()
    m = torch.stack([p[1] for p in parts]).amax(0)
    w = [torch.exp(p[1] - m) for p in parts]
    merged = sum(wi[..., None] * p[0] for wi, p in zip(w, parts)) / sum(w)[
        ..., None]
    _close(merged, whole, 1e-6)


# ---------------------------------------------------------------------------
# ragged_prefill's log-sum-exp, the merge the sharded chunked prefill runs
# ---------------------------------------------------------------------------

def _prefill_inputs(seed, B=3, T=5, Smax=24, Hq=4, Hkv=2, hd=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return f(B, T, Hq, hd), f(B, Smax, Hkv, hd), f(B, Smax, Hkv, hd)


def test_prefill_lse_matches_float64():
    """The log-sum-exp within 1e-5 of a float64 computation; the output
    with it equal to the output without it; a padded row and a row before
    the cache (a negative start) give 0 and -inf."""
    q, k, v = _prefill_inputs(0)
    start = torch.tensor([0, 11, -3], dtype=torch.int32)
    qlen = torch.tensor([5, 3, 5], dtype=torch.int32)
    out, lse = rp.ragged_prefill_attention(q, k, v, start, qlen, lse=True)
    ref = rp.ragged_prefill_attention(q, k, v, start.clamp(min=0), qlen)
    assert torch.equal(out[:2], ref[:2])
    qd, kd = q.double().reshape(3, 5, 2, 2, 8), k.double()
    s = torch.einsum("btgrh,bsgh->btgrs", qd, kd) / np.sqrt(8)
    for b in range(3):
        for i in range(5):
            p = int(start[b]) + i
            if i >= int(qlen[b]) or p < 0:
                assert torch.isneginf(lse[b, i]).all()
                assert not out[b, i].any()
                continue
            want = torch.logsumexp(s[b, i, ..., :p + 1], -1).reshape(4)
            np.testing.assert_allclose(lse[b, i].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-5)


def test_prefill_blocks_merge_to_the_whole_cache():
    """The cache cut into three blocks of 8 rows, each called at starts
    made local (negative in a block past a slot's rows), merged by the
    log-sum-exp (the maximum of a row no block reaches taken as 0, as
    ``layers._merged`` takes it): the whole cache's output, padded rows
    exactly 0, no NaN."""
    q, k, v = _prefill_inputs(1)
    start = torch.tensor([2, 9, 19], dtype=torch.int32)
    qlen = torch.tensor([5, 2, 4], dtype=torch.int32)
    whole = rp.ragged_prefill_attention(q, k, v, start, qlen)
    parts = [rp.ragged_prefill_attention(q, k[:, lo:lo + 8], v[:, lo:lo + 8],
                                         start - lo, qlen, lse=True)
             for lo in (0, 8, 16)]
    o, l = parts[2]
    assert torch.isneginf(l[0]).all() and not o[0].any()
    m = torch.stack([p[1] for p in parts]).amax(0)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = [torch.exp(p[1] - m) for p in parts]
    den = sum(w)
    merged = sum(wi[..., None] * p[0] for wi, p in zip(w, parts)) / \
        torch.where(den > 0, den, 1.0)[..., None]
    assert torch.isfinite(merged).all()
    _close(merged, whole, 1e-6)
    for b, n in enumerate(qlen.tolist()):
        assert not merged[b, n:].any()
