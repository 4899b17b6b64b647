"""``serve_open``: independent users, an open loop.  Requests are due at a
fixed rate whether or not earlier ones have finished (the traffic file's
``rate``, requests/s), each timed from its due time.  A warm-up stretch of
the same mix (``warmup_s``) fills the engine before the window opens.  The
requests due inside the window are then followed past its close, in an
untimed drain, until each has its first token (``drain_s`` at most; one
that never gets it counts as failed).

End-to-end (the cell's ``BENCHMARK.json`` entry picks): ``ttft_p95_ms``
over every request due in the window, ``tpot_p95_ms`` over every request
with tokens at two or more steps of the window, ``output_tok_s`` over
every token the engine produced in it (the measure above the knee,
where the queue grows)."""

from __future__ import annotations

from ..lib import cell, serving, traffic
from ..lib import device as dev
from ..lib import profile


def feeder(loop, reqs, arrivals, t0: float, rid0: int, in_window: bool,
           request_cls):
    """A ``feed`` for ``serving.run_until``: submits every request due by
    ``now``; returns the next due time."""
    state = {"i": 0}

    def feed(now: float):
        i = state["i"]
        while i < len(reqs) and t0 + arrivals[i] <= now:
            prompt, max_new = reqs[i]
            loop.submit(rid0 + i, prompt, max_new,
                        t0 + float(arrivals[i]), in_window, request_cls)
            i += 1
        state["i"] = i
        return t0 + float(arrivals[i]) if i < len(reqs) else None
    return feed


def serve(ctx: cell.Context, model, params, rate: float) -> dict:
    """Warm-up, the window at ``rate`` and the drain, on a new engine.
    Returns the loop and the window's edges."""
    from repro_torch.serve.engine import Request, ServeEngine
    tr, d, e = ctx.traffic, ctx.dims, ctx.traffic["engine"]
    engine = ServeEngine(model, params, max_batch=e["max_batch"],
                         max_seq=e["max_seq"], decode_chunk=e["decode_chunk"],
                         prefill_chunk_tokens=e["prefill_chunk_tokens"])
    ctx.tracer = profile.Trace() if ctx.trace else None
    loop = serving.Loop(engine, ctx.tracer)
    serving.prime(engine, Request, tr, d.V)
    if ctx.trace:
        ctx.tracer.warm()
    warm_s = float(tr["warmup_s"])
    nw = max(1, round(rate * warm_s))
    warm = traffic.requests(tr, nw, traffic.rng(ctx.seed, 1), d.V,
                            e["max_seq"])
    t = loop.clock()
    serving.run_until(loop, t + warm_s, feeder(
        loop, warm, traffic.arrivals(traffic.rng(ctx.seed, 2), nw, warm_s),
        t, 0, False, Request))

    n = max(1, round(rate * ctx.seconds))
    reqs = traffic.requests(tr, n, traffic.rng(ctx.seed, 3), d.V,
                            e["max_seq"])
    arrivals = traffic.arrivals(traffic.rng(ctx.seed, 4), n, ctx.seconds)
    t0 = ctx.window_opens()
    loop.recording = True
    t_close = serving.run_until(
        loop, t0 + ctx.seconds,
        feeder(loop, reqs, arrivals, t0, 1 << 20, True, Request),
        serving.slice_from(t0, ctx.seconds, tr) if ctx.trace else None)
    ctx.window_closed()
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop()
    loop.recording = False

    deadline = loop.clock() + float(tr["drain_s"])
    while loop.busy() and loop.clock() < deadline and any(
            lv.in_window and lv.req.t_first is None
            for lv in loop.live.values()):
        loop.step()
    return {"loop": loop, "t0": t0, "t_close": t_close, "n": n}


def run(ctx: cell.Context) -> cell.Result:
    tr, d = ctx.traffic, ctx.dims
    model, params = cell.build_program(ctx)
    out = serve(ctx, model, params, float(tr["rate"]))
    loop, t0, t_close = out["loop"], out["t0"], out["t_close"]
    ttft, missing = loop.ttfts()
    metrics = {"ttft_p95_ms": serving.p95_ms(ttft),
               "tpot_p95_ms": serving.p95_ms(loop.tpots(t0, t_close)),
               "output_tok_s": loop.tokens(t0, t_close) / (t_close - t0)}
    peak = dev.peak_bytes(ctx.device)
    compare = serving.samples(loop, ctx.seed, tr)
    late = loop.lateness()

    loop.close()
    del model, params, out
    read = cell.compare_served(ctx, compare)
    return cell.Result(
        metrics=metrics, attempted=len([lv for lv in loop.live.values()
                                        if lv.in_window]),
        failed=missing,
        checks=cell.checks(dict(read, unserved=missing), ctx.limits),
        peak_bytes=peak,
        layer={"loop": loop, "t0": t0, "t_close": t_close,
               "compare": compare,
               "trace": ctx.tracer, "dims": d, "traffic": tr,
               "notes": {"readings": read,
                         "compared_requests": len(compare),
                         "distinct_served": len({int(t) for _, s in compare
                                                 for t in s}),
                         "generator_late_s": late}})
