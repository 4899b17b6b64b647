"""SLO control-plane smoke: a fleet serving through a seeded replica
crash, with the whole observability surface live — metric registry,
time-series store, burn-rate SLO monitor, span tracer — scraped over a
TCP socket on localhost, and a decision-replay diff run against the
committed routing fixture.

Writes ``slo_timeseries.json`` and ``slo_alerts.json`` (exact endpoint
bodies) into ``--out-dir`` and exits non-zero unless the TTFT-burn alert
both fired during the crash and cleared after recovery.

    PYTHONPATH=src python -m repro_torch.examples.slo_smoke [--device cpu]

The port's counterpart of ``examples/slo_smoke.py``: the same reduced
config, crash plan, objectives and traffic; weights drawn on the device
from seed 0, heads widened to 64 (``serve_lm.example_config``).
"""

from __future__ import annotations

import argparse
import json
import os
import urllib.request

import numpy as np

from repro_torch.chaos import FaultInjector
from repro_torch.device import resolve_device
from repro_torch.examples.serve_lm import example_config, init_params
from repro_torch.models import get_model
from repro_torch.obs import (MetricRegistry, Objective, ObsServer, SLOMonitor,
                             SpanTracer, TimeSeriesStore)
from repro_torch.obs.replay import main as replay_main
from repro_torch.region.transport import LoopbackTransport
from repro_torch.router import FleetGateway
from repro_torch.serve import Request, ServeEngine

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "..", "..", "tests",
                       "fixtures", "decisions", "route_log.jsonl")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out-dir", default=".",
                    help="where the two endpoint bodies are written")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = example_config("smollm-135m")
    m = get_model(cfg)
    params = init_params(m, dev)

    # replica 1 crashes before its first prefill completes and restarts
    # later; its requests' first tokens arrive pumps late.
    inj = FaultInjector(0).crash(1, at_step=1, restart_at=8)
    gw = FleetGateway([ServeEngine(m, params, max_batch=4, max_seq=48)
                       for _ in range(2)],
                      transport=LoopbackTransport(), injector=inj,
                      heartbeat_timeout=2.0)
    reg = MetricRegistry()
    tracer = SpanTracer("fleet")
    gw.attach_obs(tracer, reg, name="fleet0")
    tss = TimeSeriesStore(reg, cap=1024)
    gw.attach_timeseries(tss)
    mon = SLOMonitor([Objective("ttft_pumps", target=0.75, threshold=2.0)],
                     fast_window=5, slow_window=15, burn_threshold=1.5)
    gw.attach_slo(mon)

    rng = np.random.default_rng(5)
    for rid in range(4):
        gw.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 8),
                          max_new=6))
    for _ in range(14):
        gw.pump()
    gw.run_until_drained(400)

    bodies = {}
    with ObsServer(registry=reg, timeseries=tss, slo=mon,
                   tracer=tracer) as srv:
        print(f"obs server listening on {srv.url}")
        for path, out in (("/metrics", None),
                          ("/timeseries", "slo_timeseries.json"),
                          ("/alerts", "slo_alerts.json"),
                          ("/traces", None)):
            with urllib.request.urlopen(srv.url + path, timeout=10) as r:
                body = bodies[path] = r.read()
            print(f"  GET {path}: {r.status} ({len(body)} bytes)")
            if out:
                with open(os.path.join(args.out_dir, out), "wb") as f:
                    f.write(body)

    alerts = json.loads(bodies["/alerts"])
    states = [(a["objective"], a["state"], a["tick"])
              for a in alerts["history"]]
    print(f"alert lifecycle: {states}")
    if ("ttft_pumps", "firing", 3) not in states:
        raise SystemExit("slo smoke: the crash never fired the alert")
    if not any(o == "ttft_pumps" and s == "cleared" for o, s, _ in states):
        raise SystemExit("slo smoke: the alert never cleared")
    if alerts["active"]:
        raise SystemExit("slo smoke: an alert is still active after "
                         "recovery")

    print("\nreplay diff of the committed routing fixture under a "
          "migration-penalized cost model:")
    rc = replay_main([FIXTURE, "--cost",
                      "queueaware+migration:fixed=0.5,per_token=0.001"])
    if rc != 0:
        raise SystemExit(f"slo smoke: replay exited {rc}")
    print("\nslo smoke OK")
    return {"gateway": gw, "alerts": states}


if __name__ == "__main__":
    main()
