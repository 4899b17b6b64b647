"""``serve_backlog``: an offline batch (evaluations, synthetic data, agent
rollouts).  The engine's queue always holds at least ``queue`` requests,
so every slot that frees is filled at once; the pool's lengths come in
blocks of ``max_batch`` that each hold the mix's stratified quantiles, so
every seed serves the same work.  Before the window opens the
slots are full and staggered: the first ``max_batch`` requests arrive with
a share of their output already done (stratified shares, in the seed's
order), as requests caught mid-flight would, and ``warmup_s`` of the mix
runs.

End-to-end: ``output_tok_s`` (every token the engine produced in the
window over its seconds), and ``tpot_p95_ms`` for a cell whose runs hold
it steady enough to bound."""

from __future__ import annotations

import numpy as np

from ..lib import cell, serving, traffic
from ..lib import device as dev
from ..lib import profile


def run(ctx: cell.Context) -> cell.Result:
    from repro_torch.serve.engine import Request, ServeEngine
    tr, d, e = ctx.traffic, ctx.dims, ctx.traffic["engine"]
    model, params = cell.build_program(ctx)
    B = e["max_batch"]
    engine = ServeEngine(model, params, max_batch=B, max_seq=e["max_seq"],
                         decode_chunk=e["decode_chunk"])
    ctx.tracer = profile.Trace() if ctx.trace else None
    loop = serving.Loop(engine, ctx.tracer)
    serving.prime(engine, Request, tr, d.V)
    if ctx.trace:
        ctx.tracer.warm()

    pool = traffic.requests(tr, int(tr["pool"]), traffic.rng(ctx.seed, 3),
                            d.V, e["max_seq"], block=B)
    share = ((np.arange(B) + 0.5) / B)[traffic.rng(ctx.seed, 5)
                                       .permutation(B)]
    for i in range(B):
        prompt, max_new = pool[i]
        loop.submit(i, prompt, max(1, round(max_new * share[i])), None,
                    False, Request)
    state = {"i": B}

    def feed(now: float):
        while engine.pending() < tr["queue"]:
            i = state["i"]
            if i >= len(pool):
                raise RuntimeError("the request pool ran dry: raise "
                                   "'pool' in the traffic file")
            loop.submit(i, *pool[i], None, False, Request)
            state["i"] = i + 1
        return None

    t = loop.clock()
    serving.run_until(loop, t + float(tr["warmup_s"]), feed)
    t0 = ctx.window_opens()
    loop.recording = True
    t_close = serving.run_until(
        loop, t0 + ctx.seconds, feed,
        serving.slice_from(t0, ctx.seconds, tr) if ctx.trace else None)
    ctx.window_closed()
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop()
    loop.recording = False

    tokens = loop.tokens(t0, t_close)
    metrics = {"output_tok_s": tokens / (t_close - t0),
               "tpot_p95_ms": serving.p95_ms(loop.tpots(t0, t_close))}
    served = sum(1 for lv in loop.live.values()
                 if any(t0 <= t <= t_close for t, _ in lv.times))
    peak = dev.peak_bytes(ctx.device)
    compare = serving.samples(loop, ctx.seed, tr)

    loop.close()
    del engine, model, params
    read = cell.compare_served(ctx, compare)
    return cell.Result(
        metrics=metrics, attempted=served, failed=0,
        checks=cell.checks(read, ctx.limits),
        peak_bytes=peak,
        layer={"loop": loop, "t0": t0, "t_close": t_close,
               "compare": compare,
               "trace": ctx.tracer, "dims": d, "traffic": tr,
               "notes": {"readings": read,
                         "compared_requests": len(compare),
                         "distinct_served": len({int(t) for _, s in compare
                                                 for t in s}),
                         "window_tokens": tokens}})
