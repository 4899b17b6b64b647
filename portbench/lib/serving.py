"""The serving loop the two serving drivers share: requests into a
``repro_torch`` ``ServeEngine``, ``engine.step()`` after ``engine.step()``,
and after each step, on the harness's clock, which request got which
tokens.  From those records come the end-to-end metrics (every request,
every token) and the per-layer readers' inputs (every step's decode slots
and positions, every prefill chunk, every whole prefill)."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import stats


@dataclasses.dataclass
class Live:
    """One request the harness submitted and follows."""
    req: object                  # the engine's Request
    n: int                       # prompt tokens
    due: float | None            # clock time it was due (open loop)
    in_window: bool              # due inside the window
    submitted: float = 0.0
    times: list = dataclasses.field(default_factory=list)  # (clock, tokens)
    seen: int = 0


@dataclasses.dataclass
class StepRec:
    t0: float
    t1: float
    k: int
    starts: list                 # (decode start position, tokens kept)
                                 # of each live slot
    kept: int                    # decode tokens kept (truncation excluded)
    prefills: list               # prompt length of each whole prefill
    chunks: list                 # (start, qlen, seconds) of each prefill
                                 # chunk
    decode_wall: float | None    # the decode chunk's wall, seconds
    traced: bool


class Loop:
    """Drives ``engine`` and records.  ``trace`` (a ``profile.Trace``)
    marks the phases of each step while it runs."""

    def __init__(self, engine, trace, clock=time.perf_counter):
        self.engine = engine
        self.spans = None
        if trace is not None:
            from repro_torch.obs import SpanTracer
            self.spans = SpanTracer("pb")
            engine.attach_obs(tracer=self.spans)
        self.trace = trace
        self.clock = clock
        self.live: dict[int, Live] = {}
        self.open: dict[int, Live] = {}      # not finished yet
        self.steps: list[StepRec] = []
        self.backlog: list[tuple[float, int]] = []   # (clock, pending)
        self.recording = False
        self._chunks: list = []
        self._decode_wall = None
        self._consumed: dict[int, int] = {}
        engine.on_prefill_latency = self._on_chunk
        engine.on_step_latency = self._on_decode
        if trace is not None:
            for name, attr in (("admit", "_admit"),
                               ("chunk", "_advance_prefill")):
                setattr(engine, attr, self._marked(name,
                                                   getattr(engine, attr)))

    def _marked(self, name, fn):
        def call():
            with self.trace.phase(name):
                return fn()
        return call

    def _on_chunk(self, dur: float) -> None:
        pf = self.engine.prefilling[0]
        before = self._consumed.get(pf.req.rid, 0)
        self._consumed[pf.req.rid] = pf.consumed
        self._chunks.append((before, pf.consumed - before, dur))

    def _on_decode(self, per_token: float) -> None:
        self._decode_wall = per_token * self.engine.decode_chunk

    def submit(self, rid: int, prompt: np.ndarray, max_new: int,
               due: float | None, in_window: bool, request_cls) -> Live:
        req = request_cls(rid=rid, prompt=prompt, max_new=max_new)
        lv = Live(req=req, n=len(prompt), due=due, in_window=in_window,
                  submitted=self.clock())
        self.live[rid] = self.open[rid] = lv
        self.engine.submit(req)
        return lv

    def busy(self) -> bool:
        return bool(self.engine.active_count() or self.engine.pending())

    def close(self) -> None:
        """Let go of the engine (and so the program's weights and cache):
        the records stay."""
        self.engine = None

    def step(self) -> None:
        self._chunks, self._decode_wall = [], None
        t0 = self.clock()
        if self.trace is not None:
            with self.trace.phase("step"):
                self.engine.step()
        else:
            self.engine.step()
        t1 = self.clock()
        starts, prefills, kept = [], [], 0
        for rid, lv in list(self.open.items()):
            got = len(lv.req.out_tokens)
            if got > lv.seen:
                lv.times.append((t1, got - lv.seen))
                first_decode = max(lv.seen, 1)
                if lv.seen == 0:
                    prefills.append(lv.n)
                if got > first_decode:
                    starts.append((lv.n + first_decode - 1,
                                   got - first_decode))
                    kept += got - first_decode
                lv.seen = got
            if lv.req.done:
                del self.open[rid]
        if self.recording:
            self.backlog.append((t1, self.engine.pending()))
            self.steps.append(StepRec(
                t0, t1, self.engine.decode_chunk, starts, kept, prefills,
                self._chunks, self._decode_wall,
                self.trace is not None and self.trace.active))

    # -- end-to-end metrics ------------------------------------------------
    def ttfts(self) -> tuple[list[float], int]:
        """(TTFT seconds of every request due in the window that has its
        first token, count of those that have none)."""
        vals, missing = [], 0
        for lv in self.live.values():
            if lv.in_window:
                if lv.req.t_first is None:
                    missing += 1
                else:
                    vals.append(lv.req.t_first - lv.due)
        return vals, missing

    def queue_waits(self) -> list[float]:
        return [lv.req.t_admit - lv.due for lv in self.live.values()
                if lv.in_window and lv.req.t_admit is not None]

    def tpots(self, lo: float, hi: float) -> list[float]:
        """Per request with tokens at two or more step ends inside
        ``[lo, hi]``: (last such time - first) / the tokens that came after
        the first step's."""
        out = []
        for lv in self.live.values():
            ts = [(t, c) for t, c in lv.times if lo <= t <= hi]
            if len(ts) >= 2:
                after = sum(c for _, c in ts[1:])
                out.append((ts[-1][0] - ts[0][0]) / after)
        return out

    def tokens(self, lo: float, hi: float) -> int:
        return sum(c for lv in self.live.values() for t, c in lv.times
                   if lo <= t <= hi)

    def lateness(self) -> float:
        """How late the generator submitted, at most (seconds)."""
        late = [lv.submitted - lv.due for lv in self.live.values()
                if lv.due is not None]
        return max(late, default=0.0)

    def sample(self, gen: np.random.Generator, count: int) -> list[Live]:
        """``count`` finished requests to compare: the longest (prompt and
        output), then others in ``gen``'s order."""
        done = [lv for lv in self.live.values()
                if lv.req.done and lv.req.out_tokens]
        if not done:
            return []
        done.sort(key=lambda lv: lv.req.rid)
        longest = max(done, key=lambda lv: lv.n + len(lv.req.out_tokens))
        rest = [done[i] for i in gen.permutation(len(done))
                if done[i] is not longest]
        return [longest] + rest[:count - 1]


def p95_ms(values) -> float | None:
    v = stats.percentile(values, 95.0)
    return None if v is None else float(v) * 1e3


def run_until(loop: Loop, t_end: float, feed, trace_from=None) -> float:
    """Step ``loop`` until ``t_end``: before each step ``feed(now)``
    submits what is due; an idle engine waits for the next due time
    (``feed`` returns it, or None).  ``trace_from``: the clock time from
    which the loop's trace records (to ``t_end``; the caller stops it).
    Returns the clock at the end of the last step."""
    last = loop.clock()
    while True:
        now = loop.clock()
        nxt = feed(now)
        if now >= t_end:
            return last
        if trace_from is not None and now >= trace_from:
            loop.trace.start()
            trace_from = None
        if loop.busy():
            loop.step()
            last = loop.clock()
        else:
            time.sleep(max(0.0, min(t_end, nxt if nxt is not None
                                    else t_end) - now))


def slice_from(t0: float, seconds: float, traffic: dict) -> float:
    """Where the traced slice starts: ``trace_slice_s`` before the window
    closes."""
    return t0 + seconds - min(float(traffic["trace_slice_s"]), seconds)


def samples(loop: Loop, seed: int, traffic: dict) -> list:
    """Host copies ``(prompt, served tokens)`` of the sample to compare."""
    from .traffic import rng
    picked = loop.sample(rng(seed, 9), traffic["check_requests"])
    return [(np.asarray(lv.req.prompt).copy(),
             np.asarray(lv.req.out_tokens, dtype=np.int64))
            for lv in picked]


def prime(engine, request_cls, traffic: dict, vocab: int) -> None:
    """Set-up's first request, before any traffic: a prompt of two chunks
    (or a whole one) and two decode chunks, so that the kernels' library
    is built and loaded and the engine's decode and chunk cells are
    captured before the first timed request arrives."""
    e = traffic["engine"]
    n = 2 * e.get("prefill_chunk_tokens", 0) or 64
    prompt = np.arange(n, dtype=np.int64) % vocab
    engine.submit(request_cls(rid=-1, prompt=prompt,
                              max_new=2 * e["decode_chunk"] + 1))
    engine.run_until_drained()
