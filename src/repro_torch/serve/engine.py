"""Ragged continuous-batching serving engine with serializable KV sessions:
the port's counterpart of ``repro/serve/engine.py``, with the same
constructor and surface.

* requests arrive with prompt tokens; **any free slot admits any queued
  prompt** — prefill runs per request (whole prompt, through the
  ``flash_attention`` kernel on the card) and its KV cache is written into
  the slot's rows of the batch cache (``Model.insert_session``);
* a request's ``extras`` (the vlm family's ``image_embeds``) go into its
  prefill batch with a batch axis of 1, on the engine's device; such a
  request always prefills whole;
* with ``prefill_chunk_tokens > 0`` a prompt instead prefills in chunks of
  that many tokens through ``Model.prefill_chunk`` (the
  ``ragged_prefill`` kernel on the card), one chunk per ``step`` between
  decode chunks, in the engine's one working prefill cache, which holds
  no slot: the oldest prefill in flight owns it, from a zeroed start (an
  imported partial prefill's rows written in first).  Done, the prompt
  takes a slot, or, with ``on_prefill_complete`` set (a prefill-role
  replica), leaves as a :class:`Session` for a decode replica; its rows
  leave the working cache before the next prefill takes it (a device
  clone if no slot is free by then).  An unfinished prefill can leave too
  (``export_prefill``) and resume its remaining chunks elsewhere;
* every engine step decodes a **chunk of ``decode_chunk`` tokens** for the
  whole active batch at **per-slot positions** through
  ``Model.decode_fused``: the cache is updated in place, greedy sampling
  runs on the device, and ``cur_token`` / ``pos`` stay on the device
  between chunks — the only host transfer per step is the ``(B, k)`` block
  of token ids.  A slot that reaches ``max_new`` (or the cache edge)
  mid-chunk keeps only its tokens up to that point.  ``fused=False`` keeps
  the legacy per-token path (``Model.decode_step`` + device argmax).  On
  the card the engine builds the cell (the CUDA graph,
  :mod:`repro_torch.models.graphs`) of ``decode_fused`` or
  ``decode_step`` for the batch cache as it allocates it, and that of
  ``prefill_chunk`` for the working prefill cache as it allocates that,
  so no decode step or prefill chunk carries a capture: one cell each an
  engine, chunk length and layout, built again after a restart;
* finished sequences free their slots immediately;
* a live request can leave the engine as a :class:`Session`
  (``export_session``) and resume on another engine (``import_session``),
  in process or as wire bytes (``export_session_wire``,
  ``import_session_wire``; :mod:`repro_torch.region.wire`), which the JAX
  package's engine reads and writes too;
* the :class:`ElasticServeScheduler` is consulted per prefill or prefill
  chunk (critical) and per decode chunk (non-critical).  Its PTT learns
  **device** time: every latency sample is taken after the host sync that
  ends the work (the ``argmax`` of a prefill or of a prompt's last chunk,
  a stream synchronisation after any other chunk, the ``(B, k)`` copy of a
  decode chunk), never after the enqueue alone;
* with a :class:`~repro_torch.obs.SpanTracer` attached (``attach_obs``)
  every step is one ``step`` span on the engine's track, kept under any
  sampling, with its decode chunk ``k``, its live slots ``active``, its
  whole prefills ``prefills`` and its PTT calls ``ptt_updates`` (every
  ``schedule_*`` and ``record``) and their host time ``ptt_ns``, counted
  around the calls.  Its children carry its index ``step``: the
  per-request ``prefill`` (and within it ``prefill.dispatch``, from
  taking the request to ``Model.prefill`` returning; the rest is its
  argmax), ``prefill-chunk``, ``decode.launch`` (the decode cell's call),
  ``decode.wait`` (the token copy) and ``trace.record``: the children are
  held until the step's work is done and recorded then, with the
  per-request ``decode-chunk`` spans, inside ``trace.record``.  What the
  children leave of the step is the engine's own host work.  Inside a
  whole prefill the model bodies record a span a layer boundary
  (``attn``, ``moe.*``: :func:`repro_torch.obs.trace.model_spans`), which
  a traced prefill pays for.  The tracer is anchored to the device
  trace's clock at the top of each step
  (:meth:`~repro_torch.obs.SpanTracer.trace_ns`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..models import Model
from ..obs import NULL_TRACER
from ..obs.trace import model_spans
from .scheduler import ElasticServeScheduler


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new: int
    tenant: int | str = 0        # fair-shedding bucket (SLOPolicy weights)
    extras: dict = dataclasses.field(default_factory=dict)
                                 # extra prefill inputs without the batch
                                 # axis (e.g. vlm "image_embeds")
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_first: float | None = None   # wall time the first token was produced
    t_admit: float | None = None   # wall time the engine started prefill


@dataclasses.dataclass
class Session:
    """A live request frozen for transport: the Request object itself (so
    the client's handle keeps accumulating tokens after migration), its
    decode position, the next input token, and its cache slice as host
    numpy arrays (``Model.extract_session``).

    A session the JAX package's engine exported imports here as it is,
    bfloat16 leaves included.  The other way, the wire is the path between
    the packages (``export_session_wire``): a port session's bfloat16
    leaves are ``uint16`` bits, which the JAX package's ``insert_session``
    would convert by value in process, and the wire names them
    ``"bfloat16"``."""
    req: Request
    pos: int
    cur_token: int
    cache: dict
    trace: dict | None = None    # trace context ({"trace_id": ...})
    prefilled: int | None = None  # None = prefill complete (a decode
                                  # session); else the prompt tokens
                                  # already consumed: a mid-prefill export
                                  # whose cache holds only those rows
    delivery: tuple | None = None  # (origin, rid, epoch) delivery id a
                                   # shipping gateway stamps (wire v4)


@dataclasses.dataclass
class _Prefill:
    """An in-progress chunked prefill: the request and how far it is.  Its
    rows live in the engine's working prefill cache while it owns it (the
    oldest in flight), written in place chunk by chunk.  It holds no batch
    slot, so a long prompt never blocks a decode slot."""
    req: Request
    consumed: int = 0            # prompt tokens already in the cache
    t_start: float | None = None  # first chunk's wall time
    session: dict | None = None  # an imported partial prefill's rows,
                                 # until it owns the working cache


@dataclasses.dataclass
class _StepTally:
    """What a traced step counts for its ``step`` span."""
    step: int = 0                # the step's index on this engine
    t0: float = 0.0
    k: int = 0                   # tokens decoded a slot
    prefills: int = 0            # whole prefills
    ptt_updates: int = 0         # schedule_* and record calls
    ptt_ns: int = 0              # their host time
    # the step's children, recorded after its end is stamped:
    # (name, trace, ts, dur, args) ...
    held: list = dataclasses.field(default_factory=list)
    # ... and its decode chunk, one ``decode-chunk`` a request:
    # (ts, dur, k, the requests' ids)
    chunk: tuple | None = None


class ServeEngine:
    def __init__(self, model: Model, params, max_batch: int, max_seq: int,
                 num_groups: int = 1, decode_chunk: int = 1,
                 fused: bool = True, role: str = "both",
                 prefill_chunk_tokens: int = 0):
        if role not in ("prefill", "decode", "both"):
            raise ValueError(f"unknown role {role!r}")
        self.model = model
        self.params = params
        self.device = params.device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.decode_chunk = max(int(decode_chunk), 1)
        self.fused = fused
        # ``role`` is a label the fleet tier routes by; the engine stays
        # fully capable either way
        self.role = role
        self.prefill_chunk_tokens = max(int(prefill_chunk_tokens), 0)
        self.crashed = False
        self.scheduler = ElasticServeScheduler(num_groups)
        self.queue: deque[Request] = deque()
        self.sessions_in: deque[Session] = deque()   # imported, not yet slotted
        self.prefilling: deque[_Prefill] = deque()   # chunked prefills in
                                                     # flight (no slot held)
        self._prefill_ready: deque[tuple[Request, int, dict]] = deque()
                                 # chunk-prefilled, waiting for a free slot
                                 # (req, next_token, device cache)
        self.active: list[Request | None] = [None] * max_batch
        self.cache = None
        self._pf_cache = None    # the working prefill cache (1, max_seq)
        self._pf_owner = None    # the _Prefill whose rows it holds
        self.pos = np.zeros(max_batch, dtype=np.int32)
        self.cur_token = np.zeros((max_batch, 1), dtype=np.int32)
        # device-resident mirrors of cur_token/pos: they ride the decode
        # outputs between chunks and are re-uploaded from the host arrays
        # only after a slot-changing event (admission, finish, export)
        # marks them dirty
        self._dev_tok = None
        self._dev_pos = None
        self._dev_dirty = True
        # fleet surface: called with each step's decode latency per token
        # (elapsed / decode_chunk); steps that run no decode leave it
        # uncalled and last_step_latency untouched
        self.on_step_latency = None
        self.last_step_latency = 0.0
        # chunked prefill reports to its own signal, never on_step_latency:
        # the fleet's interference detector needs a homogeneous decode
        # signal, and a burst of prompt chunks would read as a slow replica
        self.on_prefill_latency = None
        self.last_prefill_chunk_latency = 0.0
        # prefill-role hook: a request whose prefill just completed leaves
        # as a Session frozen straight off its prefill cache, handed to
        # this callback; it never takes a slot here
        self.on_prefill_complete = None
        self.tracer = NULL_TRACER
        self._tally = _StepTally()   # the traced step in progress
        self.metrics = None
        self.obs_name = "engine"
        self._served = 0         # requests finished on this engine
        self._exports = 0        # sessions migrated out
        self._imports = 0        # sessions migrated in
        self._m_served = self._m_tokens = None
        self._m_exports = self._m_imports = None
        self._h_prefill = self._h_step = self._h_prefill_chunk = None
        self._g_util = self._g_queue = None

    # -- observability -----------------------------------------------------
    def attach_obs(self, tracer=None, metrics=None,
                   name: str | None = None) -> None:
        """Attach a :class:`~repro_torch.obs.SpanTracer` and/or a metric
        registry (anything with the reference ``MetricRegistry``'s
        ``counter`` / ``histogram`` / ``gauge``).  ``name`` labels this
        engine's series and is its span track.  Metric children are
        resolved once here so the decode loop pays a float add."""
        if name is not None:
            self.obs_name = name
        if tracer is not None:
            self.tracer = tracer
        if metrics is not None:
            self.metrics = metrics
            e = self.obs_name
            self._m_served = metrics.counter(
                "serve_requests_served_total",
                "Requests finished on this engine", engine=e)
            self._m_tokens = metrics.counter(
                "serve_decode_tokens_total",
                "Tokens decoded (batch slots x chunk)", engine=e)
            self._m_exports = metrics.counter(
                "serve_sessions_exported_total",
                "Live sessions migrated out", engine=e)
            self._m_imports = metrics.counter(
                "serve_sessions_imported_total",
                "Live sessions migrated in", engine=e)
            self._h_prefill = metrics.histogram(
                "serve_prefill_seconds", "Per-request prefill wall time",
                engine=e)
            self._h_step = metrics.histogram(
                "serve_decode_step_seconds",
                "Decode latency per token (elapsed / chunk)", engine=e)
            self._h_prefill_chunk = metrics.histogram(
                "serve_prefill_chunk_seconds",
                "Per-chunk prefill wall time (chunked admission)",
                engine=e, role=self.role)
            self._g_util = metrics.gauge(
                "serve_utilization",
                "Fraction of batch slots occupied", engine=e)
            self._g_queue = metrics.gauge(
                "serve_queue_depth",
                "Requests queued but not slotted", engine=e)

    def stats(self) -> dict:
        """Counter facade with the reference's unified key names plus
        engine-local detail."""
        return {
            "requests_served": self._served,
            "requests_shed": 0,          # engines never shed; the router does
            "sessions_migrated": self._exports + self._imports,
            "queue_depth": self.pending(),
            "sessions_exported": self._exports,
            "sessions_imported": self._imports,
            "active": self.active_count(),
            "utilization": self.utilization(),
            "role": self.role,
            "crashed": self.crashed,
            "prefilling": len(self.prefilling) + len(self._prefill_ready),
        }

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # -- crash / restart (fault injection surface) -------------------------
    def crash(self) -> None:
        """Simulate process death: queued requests, in-flight prefills,
        imported sessions, the batch cache and every active slot are lost.
        Idempotent."""
        self.crashed = True
        self.queue.clear()
        self.sessions_in.clear()
        self.prefilling.clear()
        self._prefill_ready.clear()
        self.active = [None] * self.max_batch
        self.cache = None
        self._pf_cache = None
        self._pf_owner = None
        self.pos[:] = 0
        self.cur_token[:] = 0
        self._dev_tok = None
        self._dev_pos = None
        self._dev_dirty = True

    def restart(self) -> None:
        """Bring a crashed engine back empty (a replacement process with
        the same weights); work submitted while it was dead is dropped."""
        self.queue.clear()
        self.sessions_in.clear()
        self.crashed = False

    # -- non-blocking fleet surface ----------------------------------------
    def pending(self) -> int:
        """Requests queued (fresh, imported sessions, chunked prefills in
        flight, or prefilled-and-waiting) but not slotted."""
        return (len(self.queue) + len(self.sessions_in)
                + len(self.prefilling) + len(self._prefill_ready))

    def active_count(self) -> int:
        return sum(r is not None for r in self.active)

    def utilization(self) -> float:
        """Fraction of batch slots occupied (0.0 = idle replica)."""
        return self.active_count() / self.max_batch

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _zero_cache(self, batch: int) -> dict:
        spec = self.model.cache_spec(batch, self.max_seq)
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, (shape, dt) in spec.items()}

    def _ensure_cache(self) -> None:
        if self.cache is None:
            self.cache = self._zero_cache(self.max_batch)
            if self.device.type == "cuda":
                self._prepare_decode()

    def _prepare_decode(self) -> None:
        """Build the decode cell of the new cache (the CUDA graph of
        ``decode_fused`` at this batch and chunk, or of ``decode_step``
        with ``fused=False``; :mod:`repro_torch.models.graphs`) before any
        slot holds a sequence: at startup and after a restart.  A build
        runs the decode once eagerly and captures it, a few hundred ms,
        which in the first decode step would reach the PTT and the fleet's
        detector as this replica's step time.  The eager run decodes every
        slot at position 0, the throwaway decode an idle slot runs every
        step; a slot's prefill or imported session overwrites that row and
        state."""
        fn = self.model.decode_fused if self.fused else self.model.decode_step
        prepare = getattr(fn, "prepare", None)
        if prepare is not None:
            tok = torch.zeros((self.max_batch, 1), dtype=torch.long,
                              device=self.device)
            pos = torch.zeros(self.max_batch, dtype=torch.int32,
                              device=self.device)
            extra = (self.decode_chunk,) if self.fused else ()
            prepare(self.params, tok, pos, self.cache, *extra)

    def _chunk_inputs(self, chunk: np.ndarray, start: int, qlen: int):
        """A chunk's (tokens (1, C), start (1,), qlen (1,)) on the device,
        as every chunk call and the cell's build take them."""
        return (torch.from_numpy(chunk).to(self.device),
                torch.tensor([start], dtype=torch.int32, device=self.device),
                torch.tensor([qlen], dtype=torch.int32, device=self.device))

    def _ensure_prefill_cache(self) -> dict:
        """The working prefill cache, allocated on first use (and again
        after a crash), with its chunk cell built on the card as it is
        allocated: a warm-up chunk with ``qlen`` 0, which writes no row,
        then the capture, outside every chunk's PTT sample."""
        if self._pf_cache is None:
            self._pf_cache = self._zero_cache(1)
            prepare = getattr(self.model.prefill_chunk, "prepare", None)
            if prepare is not None and self.device.type == "cuda":
                chunk = np.zeros((1, self.prefill_chunk_tokens), np.int64)
                tokens, start, qlen = self._chunk_inputs(chunk, 0, 0)
                prepare(self.params, tokens, self._pf_cache, start, qlen)
        return self._pf_cache

    def _own_prefill_cache(self, pf: _Prefill) -> dict:
        """Hand the working cache to ``pf``: a finished prefill still
        waiting in ``_prefill_ready`` on it gets a device clone of its
        rows, the cache is zeroed (each prefill starts on a zero cache, as
        the reference's does, so sessions cut from it are byte-identical),
        and an imported partial prefill's rows are written in."""
        cache = self._ensure_prefill_cache()
        if self._pf_owner is not pf:
            for i, (req, tok, c) in enumerate(self._prefill_ready):
                if c is cache:
                    self._prefill_ready[i] = (
                        req, tok, {n: t.clone() for n, t in c.items()})
            for t in cache.values():
                t.zero_()
            if pf.session is not None:
                self.model.insert_session(cache, 0, pf.session)
                pf.session = None
            self._pf_owner = pf
        return cache

    def _prefill_rows(self, pf: _Prefill, k: int) -> dict:
        """A session dict of ``pf``'s first ``k`` rows: off the working
        cache when ``pf`` owns it, else off a zero cache holding its
        imported rows, if any (a prefill that has not started)."""
        if self._pf_owner is pf:
            return self.model.extract_session(self._pf_cache, 0, k)
        cache = self._zero_cache(1)
        if pf.session is not None:
            self.model.insert_session(cache, 0, pf.session)
        return self.model.extract_session(cache, 0, k)

    def _chunking(self) -> bool:
        """Whether chunked prefill admission is live on this engine."""
        return (self.prefill_chunk_tokens > 0
                and self.model.prefill_chunk is not None)

    def _slot_in(self, slot: int, req: Request, next_tok: int,
                 cache) -> None:
        """Install a freshly prefilled request into a batch slot (its cache
        a whole-prompt prefill cache or a chunked (1, max_seq) one)."""
        self._ensure_cache()
        self.model.insert_session(self.cache, slot, cache)
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)
        self.cur_token[slot, 0] = next_tok
        self._dev_dirty = True

    def _complete_prefill(self, req: Request, next_tok: int, cache) -> bool:
        """Prefill epilogue (whole-prompt and chunked): stamp the first
        token, then finish, hand off, or return False so the caller slots
        the request here.  With ``on_prefill_complete`` set the live
        session is frozen straight off the prefill cache and handed to the
        callback: no slot, no decode on this engine."""
        req.out_tokens.append(next_tok)
        req.t_first = time.perf_counter()
        if len(req.out_tokens) >= req.max_new:
            req.done = True          # finished at prefill: no slot used
            self._finish(req)
            return True
        if self.on_prefill_complete is not None:
            sess = Session(
                req=req, pos=len(req.prompt), cur_token=next_tok,
                cache=self.model.extract_session(cache, 0, len(req.prompt)))
            self._exports += 1
            if self._m_exports is not None:
                self._m_exports.inc()
            if self.tracer.enabled:
                tid = self.tracer.trace_for(req.rid)
                if tid is not None:
                    sess.trace = {"trace_id": tid}
                    self.tracer.instant("prefill-handoff", tid,
                                        self.obs_name, pos=sess.pos)
            self.on_prefill_complete(sess)
            return True
        return False

    def _ptt(self, call, *args):
        """A PTT call (``schedule_*`` or ``record``), counted and timed on
        the host for the traced step's span: each lasts microseconds, too
        short for a span of its own."""
        if not self.tracer.enabled:
            return call(*args)
        t0 = time.perf_counter_ns()
        out = call(*args)
        self._tally.ptt_ns += time.perf_counter_ns() - t0
        self._tally.ptt_updates += 1
        return out

    def _model_spans(self, rid):
        """The context a whole prefill's model bodies record their spans
        in: ``rid``'s trace on this engine's track, tagged with the step;
        none with the tracer off or ``rid`` sampled out."""
        tid = self.tracer.trace_for(rid) if self.tracer.enabled else None
        if tid is None:
            return contextlib.nullcontext()
        return model_spans(self.tracer, tid, self.obs_name,
                           step=self._tally.step)

    def _admit(self) -> None:
        # ragged continuous batching: any free slot takes any queued prompt
        # (chunk-prefilled requests first, their cache already on the
        # device, then imported sessions, whose prefill was paid elsewhere)
        slots = self._free_slots()
        while slots and self._prefill_ready:
            req, next_tok, cache = self._prefill_ready.popleft()
            self._slot_in(slots.pop(0), req, next_tok, cache)
        while slots and self.sessions_in:
            self._install_session(slots.pop(0), self.sessions_in.popleft())
        while self.queue:
            # a request with extras (a vlm image) prefills whole
            if self._chunking() and not self.queue[0].extras:
                # chunked admission holds no slot: the prompt prefills in
                # its own cache, one chunk per step, and claims a slot (or
                # ships) only when done
                if len(self.prefilling) >= self.max_batch:
                    break
                req = self.queue.popleft()
                req.t_admit = time.perf_counter()
                self.prefilling.append(_Prefill(req=req))
                continue
            if not slots and self.on_prefill_complete is None:
                break                # whole-prompt path needs a slot unless
                                     # every completion hands off
            req = self.queue.popleft()
            t0 = time.perf_counter()
            req.t_admit = t0
            d = self._ptt(self.scheduler.schedule_prefill, len(req.prompt))
            batch = {"tokens": torch.as_tensor(np.asarray(req.prompt),  # analysis: allow-host-sync(prompt is host numpy, no device transfer)
                                               device=self.device
                                               ).long()[None, :]}
            for name, val in req.extras.items():
                batch[name] = torch.tensor(np.asarray(val),  # analysis: allow-host-sync(extras are host numpy, no device transfer)
                                           device=self.device)[None]
            with self._model_spans(req.rid):
                logits, cache = self.model.prefill(self.params, batch)
            t_ret = time.perf_counter() if self.tracer.enabled else 0.0
            # the prefill's ONE host sync; the PTT sample is taken after it
            next_tok = int(torch.argmax(logits[0, -1]))  # analysis: allow-host-sync(the one sanctioned sync per whole-prompt prefill)
            prefill_dur = time.perf_counter() - t0
            self._ptt(self.scheduler.record, d, prefill_dur,
                      time.perf_counter())
            if self.tracer.enabled:
                self._tally.prefills += 1
                tid = self.tracer.trace_for(req.rid)
                if tid is not None:
                    self._tally.held += [
                        ("prefill", tid, t0, prefill_dur,
                         {"prompt_len": len(req.prompt)}),
                        ("prefill.dispatch", tid, t0, t_ret - t0, {})]
            if self._h_prefill is not None:
                self._h_prefill.observe(prefill_dur)
            if self._complete_prefill(req, next_tok, cache):
                continue             # finished at prefill or handed off
            self._slot_in(slots.pop(0), req, next_tok, cache)

    def _advance_prefill(self) -> None:
        """Run ONE chunk of the oldest in-flight chunked prefill: called once
        per step, so a long prompt prefills between decode chunks instead
        of blocking them.  Its latency goes to ``on_prefill_latency``,
        ``last_prefill_chunk_latency`` and the PTT, never to the decode
        step hook."""
        if not self.prefilling:
            return
        pf = self.prefilling[0]
        cache = self._own_prefill_cache(pf)
        prompt = np.asarray(pf.req.prompt)  # analysis: allow-host-sync(prompt is host numpy, no device transfer)
        C = self.prefill_chunk_tokens
        qlen = min(C, len(prompt) - pf.consumed)
        t0 = time.perf_counter()
        if pf.t_start is None:
            pf.t_start = t0
        d = self._ptt(self.scheduler.schedule_prefill, qlen)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :qlen] = prompt[pf.consumed:pf.consumed + qlen]
        tokens, start, live = self._chunk_inputs(chunk, pf.consumed, qlen)
        logits, cache = self.model.prefill_chunk(self.params, tokens, cache,
                                                 start, live)
        pf.consumed += qlen
        done = pf.consumed >= len(prompt)
        # the chunk's one host sync, before the PTT sample: the argmax of
        # the last chunk; after any other, a wait that copies nothing (CPU
        # tensors are computed synchronously)
        if done:
            next_tok = int(torch.argmax(logits[0, -1]))  # analysis: allow-host-sync(the one sanctioned sync per prefill chunk)
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # analysis: allow-host-sync(the one sanctioned sync per prefill chunk)
        dur = time.perf_counter() - t0
        self._ptt(self.scheduler.record, d, dur, time.perf_counter())
        self.last_prefill_chunk_latency = dur
        if self._h_prefill_chunk is not None:
            self._h_prefill_chunk.observe(dur)
        if self.tracer.enabled:
            tid = self.tracer.trace_for(pf.req.rid)
            if tid is not None:
                self._tally.held.append(
                    ("prefill-chunk", tid, t0, dur,
                     {"tokens": qlen, "consumed": pf.consumed}))
        if self.on_prefill_latency is not None:
            self.on_prefill_latency(dur)
        if done:
            # its rows stay in the working cache until they are slotted
            # (the next step's admission) or the next prefill takes it
            self.prefilling.popleft()
            self._pf_owner = None
            if self._h_prefill is not None:
                self._h_prefill.observe(time.perf_counter() - pf.t_start)
            if not self._complete_prefill(pf.req, next_tok, cache):
                self._prefill_ready.append((pf.req, next_tok, cache))

    def _finish(self, req: Request) -> None:
        """Bookkeep one finished request (counter + optional instant)."""
        self._served += 1
        if self._m_served is not None:
            self._m_served.inc()
        if self.tracer.enabled:
            self.tracer.instant("finish", self.tracer.trace_for(req.rid),
                                self.obs_name, tokens=len(req.out_tokens))

    # -- session migration -------------------------------------------------
    def export_session(self, rid: int) -> Session:
        """Freeze an active request into a transportable Session and free
        its slot.  Raises KeyError if ``rid`` is not active."""
        for slot, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                pos = int(self.pos[slot])
                sess = Session(
                    req=req, pos=pos, cur_token=int(self.cur_token[slot, 0]),
                    cache=self.model.extract_session(self.cache, slot, pos))
                self.active[slot] = None
                self.pos[slot] = 0
                self.cur_token[slot, 0] = 0
                self._dev_dirty = True
                self._exports += 1
                if self._m_exports is not None:
                    self._m_exports.inc()
                if self.tracer.enabled:
                    tid = self.tracer.trace_for(rid)
                    if tid is not None:      # sampled-out rids carry none
                        sess.trace = {"trace_id": tid}
                        self.tracer.instant("migrate-out", tid,
                                            self.obs_name, pos=pos)
                return sess
        raise KeyError(f"rid {rid} is not active on this engine")

    def export_prefill(self, rid: int) -> Session:
        """Freeze an in-progress chunked prefill into a partial Session
        (``prefilled`` = prompt tokens already consumed; the cache holds
        exactly those rows).  The importing engine resumes the remaining
        chunks.  Raises KeyError if ``rid`` is not mid-prefill here."""
        for i, pf in enumerate(self.prefilling):
            if pf.req.rid == rid:
                del self.prefilling[i]
                k = pf.consumed
                sess = Session(req=pf.req, pos=k, cur_token=0,
                               cache=self._prefill_rows(pf, k), prefilled=k)
                if self._pf_owner is pf:
                    self._pf_owner = None
                self._exports += 1
                if self._m_exports is not None:
                    self._m_exports.inc()
                if self.tracer.enabled:
                    tid = self.tracer.trace_for(rid)
                    if tid is not None:
                        sess.trace = {"trace_id": tid}
                        self.tracer.instant("migrate-out", tid,
                                            self.obs_name, pos=k,
                                            prefilled=k)
                return sess
        raise KeyError(f"rid {rid} is not mid-prefill on this engine")

    def can_hold(self, pos: int, remaining: int) -> bool:
        """Whether a session at ``pos`` with ``remaining`` tokens to decode
        fits this engine without truncation."""
        return not self.crashed and pos + remaining <= self.max_seq - 1

    def import_session(self, sess: Session, strict: bool = True) -> None:
        """Accept a migrated session; it resumes decoding at the next
        ``step`` with a free slot (ahead of fresh prompts).  ``strict``
        also requires the engine to hold the session's remaining token
        budget."""
        if self.crashed:
            raise ValueError("engine is crashed; restart() before imports")
        if sess.prefilled is not None:
            self._import_partial(sess)
            return
        if sess.pos >= self.max_seq - 1:
            raise ValueError(
                f"session at pos {sess.pos} does not fit max_seq "
                f"{self.max_seq}")
        remaining = max(sess.req.max_new - len(sess.req.out_tokens), 0)
        if strict and not self.can_hold(sess.pos, remaining):
            raise ValueError(
                f"session at pos {sess.pos} with {remaining} tokens to go "
                f"would truncate at max_seq {self.max_seq}")
        self._imports += 1
        if self._m_imports is not None:
            self._m_imports.inc()
        if sess.trace is not None:
            self.tracer.adopt(sess.req.rid, sess.trace["trace_id"])
        if self.tracer.enabled:
            self.tracer.instant("migrate-in",
                                self.tracer.trace_for(sess.req.rid),
                                self.obs_name, pos=sess.pos)
        self.sessions_in.append(sess)

    def _import_partial(self, sess: Session) -> None:
        """Adopt a mid-prefill session: its cache rows land in the working
        prefill cache when it takes it, and the remaining chunks resume
        from ``sess.prefilled``."""
        if not self._chunking():
            raise ValueError(
                "partial-prefill session needs a chunked-prefill engine "
                "(prefill_chunk_tokens > 0)")
        plen = len(sess.req.prompt)
        if not self.can_hold(plen, max(sess.req.max_new, 1)):
            raise ValueError(
                f"prompt of {plen} with {sess.req.max_new} to decode does "
                f"not fit max_seq {self.max_seq}")
        self._imports += 1
        if self._m_imports is not None:
            self._m_imports.inc()
        if sess.trace is not None:
            self.tracer.adopt(sess.req.rid, sess.trace["trace_id"])
        if self.tracer.enabled:
            tid = self.tracer.trace_for(sess.req.rid)
            if tid is not None:
                self.tracer.instant("migrate-in", tid, self.obs_name,
                                    pos=sess.pos, prefilled=sess.prefilled)
        self.prefilling.append(_Prefill(req=sess.req, consumed=sess.prefilled,
                                        session=sess.cache))

    def export_session_wire(self, rid: int) -> bytes:
        """:meth:`export_session` encoded with the versioned session wire
        format (:mod:`repro_torch.region.wire`): the byte form that crosses
        process boundaries, and the one the JAX package's engine reads."""
        from ..region.wire import encode_session   # avoid import cycle
        return encode_session(self.export_session(rid))

    def import_session_wire(self, data: bytes, strict: bool = True) -> None:
        """Accept a session shipped as wire bytes (either package's);
        validation errors raise
        :class:`~repro_torch.region.wire.WireFormatError` before any state
        is touched."""
        from ..region.wire import decode_session   # avoid import cycle
        self.import_session(decode_session(data), strict=strict)

    def active_pos(self, rid: int) -> int | None:
        """Decode position of an active request (None if not active)."""
        for slot, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                return int(self.pos[slot])
        return None

    def drain_queue(self) -> list[Request]:
        """Remove and return every request not yet started, in-flight
        chunked prefills included: they have emitted no token, so they can
        restart elsewhere (``export_prefill`` keeps the partial work)."""
        out = list(self.queue) + [pf.req for pf in self.prefilling]
        self.queue.clear()
        self.prefilling.clear()
        self._pf_owner = None
        return out

    def drain_sessions(self) -> list[Session]:
        """Remove and return imported-but-unslotted sessions, and requests
        that finished a chunked prefill but wait for a slot, as full
        sessions (their first token is already stamped)."""
        out = list(self.sessions_in)
        self.sessions_in.clear()
        for req, next_tok, cache in self._prefill_ready:
            out.append(Session(
                req=req, pos=len(req.prompt), cur_token=next_tok,
                cache=self.model.extract_session(cache, 0,
                                                 len(req.prompt))))
        self._prefill_ready.clear()
        return out

    def _install_session(self, slot: int, sess: Session) -> None:
        self._ensure_cache()
        self.model.insert_session(self.cache, slot, sess.cache)
        self.active[slot] = sess.req
        self.pos[slot] = sess.pos
        self.cur_token[slot, 0] = sess.cur_token
        self._dev_dirty = True

    # -- decode loop ---------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admit, run one prefill chunk if any is in
        flight, and decode one ``decode_chunk``-token chunk for the batch
        at per-slot positions.  Returns the number of active sequences.
        ``last_step_latency`` and ``on_step_latency`` receive the decode
        latency per token (elapsed / chunk).  Traced, the step is one
        ``step`` span (module docstring)."""
        if self.crashed:
            return 0                 # a dead process steps nothing
        if not self.tracer.enabled:
            return self._step()
        self.tracer.anchor()
        st = self._tally = _StepTally(step=self._tally.step + 1,
                                      t0=time.perf_counter())
        n_active = 0
        try:
            n_active = self._step()
        finally:
            self._record_step(st, n_active)
        return n_active

    def _record_step(self, st: _StepTally, n_active: int) -> None:
        """Record a traced step's spans once its work is done: its held
        children, then ``trace.record`` over the time that recording took
        and the ``step`` span around all of it.  So the tracer's own cost
        is a child of the step, not the engine's work."""
        tr, track = self.tracer, self.obs_name
        t1 = time.perf_counter()
        for name, trace, ts, dur, args in st.held:
            tr.complete(name, trace, track, ts=ts, dur=dur, step=st.step,
                        **args)
        if st.chunk is not None:
            ts, dur, k, rids = st.chunk
            for rid in rids:
                tr.complete("decode-chunk", tr.trace_for(rid), track,
                            ts=ts, dur=dur, tokens=k)
        t2 = time.perf_counter()
        tr.complete("trace.record", track, track, ts=t1, dur=t2 - t1,
                    step=st.step)
        tr.complete("step", track, track, ts=st.t0, dur=t2 - st.t0,
                    step=st.step, k=st.k, active=n_active,
                    prefills=st.prefills, ptt_updates=st.ptt_updates,
                    ptt_ns=st.ptt_ns)

    def _step(self) -> int:
        self._admit()
        self._advance_prefill()
        n_active = self.active_count()
        if self._g_util is not None:
            self._g_util.set(n_active / self.max_batch)
            self._g_queue.set(float(self.pending()))
        if n_active == 0:
            return 0
        d = self._ptt(self.scheduler.schedule_decode, 0)
        t0 = time.perf_counter()
        if self._dev_dirty or self._dev_tok is None:
            self._dev_tok = torch.tensor(self.cur_token, dtype=torch.long,
                                         device=self.device)
            self._dev_pos = torch.tensor(self.pos, device=self.device)
            self._dev_dirty = False
        t_call = time.perf_counter() if self.tracer.enabled else 0.0
        if self.fused:
            k = self.decode_chunk
            toks_dev, self._dev_tok, self._dev_pos, self.cache = (
                self.model.decode_fused(self.params, self._dev_tok,
                                        self._dev_pos, self.cache, k))
        else:
            # legacy per-step path: argmax on the device, (B, 1) ids home
            k = 1
            logits, self.cache = self.model.decode_step(
                self.params, self._dev_tok, self._dev_pos, self.cache)
            toks_dev = torch.argmax(logits[:, 0], dim=-1)[:, None]
            self._dev_tok = toks_dev
            self._dev_pos = self._dev_pos + 1
        t_ret = time.perf_counter() if self.tracer.enabled else 0.0
        # the chunk's ONE host sync: a (B, k) block of token ids; the PTT
        # sample below is taken after it, so it measures device time
        toks = toks_dev.cpu().numpy()  # analysis: allow-host-sync(the one sanctioned sync per decode chunk)
        decode_elapsed = time.perf_counter() - t0
        self._ptt(self.scheduler.record, d, decode_elapsed,
                  time.perf_counter())
        if self.tracer.enabled:
            st = self._tally
            st.k = k
            st.held += [
                ("decode.launch", self.obs_name, t_call, t_ret - t_call, {}),
                ("decode.wait", self.obs_name, t_ret,
                 t0 + decode_elapsed - t_ret, {})]
            st.chunk = (t0, decode_elapsed, k,
                        [r.rid for r in self.active if r is not None])
        for i, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(k):
                req.out_tokens.append(int(toks[i, j]))
                self.pos[i] += 1
                self.cur_token[i, 0] = int(toks[i, j])
                if (len(req.out_tokens) >= req.max_new
                        or self.pos[i] >= self.max_seq - 1):
                    req.done = True              # surplus chunk tokens (j+1
                    self.active[i] = None        # onward) are truncated
                    self.pos[i] = 0
                    self.cur_token[i, 0] = 0
                    self._dev_dirty = True
                    self._finish(req)
                    break
        if any(r is None for r in self.active):
            # keep idle slots' device pos pinned at 0, so an idle slot's
            # throwaway decode never sweeps more of the cache than one row
            self._dev_dirty = True
        per_token = decode_elapsed / k
        self.last_step_latency = per_token
        if self._h_step is not None:
            self._h_step.observe(per_token)
            self._m_tokens.inc(n_active * k)
        if self.on_step_latency is not None:
            self.on_step_latency(per_token)
        return n_active

    def run_until_drained(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and not self.pending():
                return
