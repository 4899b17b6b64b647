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
  decode chunks, in a cache of its own that holds no slot; it takes a slot
  when done, or, with ``on_prefill_complete`` set (a prefill-role
  replica), leaves as a :class:`Session` for a decode replica.  An
  unfinished prefill can leave too (``export_prefill``) and resume its
  remaining chunks elsewhere;
* every engine step decodes a **chunk of ``decode_chunk`` tokens** for the
  whole active batch at **per-slot positions** through
  ``Model.decode_fused``: the cache is updated in place, greedy sampling
  runs on the device, and ``cur_token`` / ``pos`` stay on the device
  between chunks — the only host transfer per step is the ``(B, k)`` block
  of token ids.  A slot that reaches ``max_new`` (or the cache edge)
  mid-chunk keeps only its tokens up to that point.  ``fused=False`` keeps
  the legacy per-token path (``Model.decode`` + device argmax);
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
  decode chunk), never after the enqueue alone.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..models import Model
from ..obs import NULL_TRACER
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
    """An in-progress chunked prefill: the request and its own (L, 1,
    max_seq, ...) device cache, written in place chunk by chunk.  It holds
    no batch slot, so a long prompt never blocks a decode slot."""
    req: Request
    cache: dict
    consumed: int = 0            # prompt tokens already in the cache
    t_start: float | None = None  # first chunk's wall time


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
                self.prefilling.append(
                    _Prefill(req=req, cache=self._zero_cache(1)))
                continue
            if not slots and self.on_prefill_complete is None:
                break                # whole-prompt path needs a slot unless
                                     # every completion hands off
            req = self.queue.popleft()
            t0 = time.perf_counter()
            req.t_admit = t0
            d = self.scheduler.schedule_prefill(len(req.prompt))
            batch = {"tokens": torch.as_tensor(np.asarray(req.prompt),  # analysis: allow-host-sync(prompt is host numpy, no device transfer)
                                               device=self.device
                                               ).long()[None, :]}
            for name, val in req.extras.items():
                batch[name] = torch.tensor(np.asarray(val),  # analysis: allow-host-sync(extras are host numpy, no device transfer)
                                           device=self.device)[None]
            logits, cache = self.model.prefill(self.params, batch)
            # the prefill's ONE host sync; the PTT sample is taken after it
            next_tok = int(torch.argmax(logits[0, -1]))  # analysis: allow-host-sync(the one sanctioned sync per whole-prompt prefill)
            prefill_dur = time.perf_counter() - t0
            self.scheduler.record(d, prefill_dur, time.perf_counter())
            if self.tracer.enabled:
                tid = self.tracer.trace_for(req.rid)
                if tid is not None:
                    self.tracer.complete(
                        "prefill", tid, self.obs_name,
                        ts=t0, dur=prefill_dur, prompt_len=len(req.prompt))
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
        prompt = np.asarray(pf.req.prompt)  # analysis: allow-host-sync(prompt is host numpy, no device transfer)
        C = self.prefill_chunk_tokens
        qlen = min(C, len(prompt) - pf.consumed)
        t0 = time.perf_counter()
        if pf.t_start is None:
            pf.t_start = t0
        d = self.scheduler.schedule_prefill(qlen)
        chunk = np.zeros((1, C), np.int64)
        chunk[0, :qlen] = prompt[pf.consumed:pf.consumed + qlen]
        logits, pf.cache = self.model.prefill_chunk(
            self.params, torch.from_numpy(chunk).to(self.device), pf.cache,
            torch.tensor([pf.consumed], dtype=torch.int32,
                         device=self.device),
            torch.tensor([qlen], dtype=torch.int32, device=self.device))
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
        self.scheduler.record(d, dur, time.perf_counter())
        self.last_prefill_chunk_latency = dur
        if self._h_prefill_chunk is not None:
            self._h_prefill_chunk.observe(dur)
        if self.tracer.enabled:
            tid = self.tracer.trace_for(pf.req.rid)
            if tid is not None:
                self.tracer.complete("prefill-chunk", tid, self.obs_name,
                                     ts=t0, dur=dur, tokens=qlen,
                                     consumed=pf.consumed)
        if self.on_prefill_latency is not None:
            self.on_prefill_latency(dur)
        if done:
            self.prefilling.popleft()
            if self._h_prefill is not None:
                self._h_prefill.observe(time.perf_counter() - pf.t_start)
            if not self._complete_prefill(pf.req, next_tok, pf.cache):
                self._prefill_ready.append((pf.req, next_tok, pf.cache))

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
                sess = Session(
                    req=pf.req, pos=k, cur_token=0,
                    cache=self.model.extract_session(pf.cache, 0, k),
                    prefilled=k)
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
        """Adopt a mid-prefill session: its cache rows land in a fresh
        per-request device cache, and the remaining chunks resume from
        ``sess.prefilled``."""
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
        cache = self.model.insert_session(self._zero_cache(1), 0, sess.cache)
        self.prefilling.append(
            _Prefill(req=sess.req, cache=cache, consumed=sess.prefilled))

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
        latency per token (elapsed / chunk)."""
        if self.crashed:
            return 0                 # a dead process steps nothing
        self._admit()
        self._advance_prefill()
        n_active = self.active_count()
        if self._g_util is not None:
            self._g_util.set(n_active / self.max_batch)
            self._g_queue.set(float(self.pending()))
        if n_active == 0:
            return 0
        d = self.scheduler.schedule_decode(group=0)
        t0 = time.perf_counter()
        if self._dev_dirty or self._dev_tok is None:
            self._dev_tok = torch.tensor(self.cur_token, dtype=torch.long,
                                         device=self.device)
            self._dev_pos = torch.tensor(self.pos, device=self.device)
            self._dev_dirty = False
        if self.fused:
            k = self.decode_chunk
            toks_dev, self._dev_tok, self._dev_pos, self.cache = (
                self.model.decode_fused(self.params, self._dev_tok,
                                        self._dev_pos, self.cache, k))
        else:
            # legacy per-step path: argmax on the device, (B, 1) ids home
            k = 1
            logits, self.cache = self.model.decode(
                self.params, self._dev_tok, self._dev_pos, self.cache)
            toks_dev = torch.argmax(logits[:, 0], dim=-1)[:, None]
            self._dev_tok = toks_dev
            self._dev_pos = self._dev_pos + 1
        # the chunk's ONE host sync: a (B, k) block of token ids; the PTT
        # sample below is taken after it, so it measures device time
        toks = toks_dev.cpu().numpy()  # analysis: allow-host-sync(the one sanctioned sync per decode chunk)
        decode_elapsed = time.perf_counter() - t0
        self.scheduler.record(d, decode_elapsed, time.perf_counter())
        if self.tracer.enabled:
            for req in self.active:
                if req is not None:
                    self.tracer.complete(
                        "decode-chunk", self.tracer.trace_for(req.rid),
                        self.obs_name, ts=t0, dur=decode_elapsed, tokens=k)
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
