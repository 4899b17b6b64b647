"""Fleet serving walkthrough: a FleetGateway fronts two real ServeEngine
replicas; the FleetRouter classifies and routes each request via the
FleetPTT, harvests TTFT/TPOT observations, and watches every replica's
step-latency stream for interference.

    PYTHONPATH=src python -m repro_torch.examples.fleet_serve [--device cpu]

The port's counterpart of ``examples/fleet_serve.py``: the same reduced
config, replicas and traffic; weights drawn on the device from seed 0,
heads widened to 64 (``serve_lm.example_config``).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.examples.serve_lm import example_config, init_params
from repro_torch.models import get_model
from repro_torch.router import FleetGateway
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = example_config("smollm-135m")
    m = get_model(cfg)
    params = init_params(m, dev)
    engines = [ServeEngine(m, params, max_batch=2, max_seq=32)
               for _ in range(2)]
    gw = FleetGateway(engines)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8), max_new=6)
            for i in range(8)]
    for r in reqs:
        d = gw.submit(r)
        print(f"req {r.rid}: class={d.req_class.name} -> "
              f"replica {d.replica} ({d.action.value})")
    gw.run_until_drained()

    print(f"\nTTFT per request (s, {dev}):")
    for rid, ttft in sorted(gw.ttfts().items()):
        print(f"  req {rid}: {ttft:.3f}")
    st = gw.stats()
    print(f"\nserved={st['served']} per_replica={st['per_replica']} "
          f"quarantined={st['quarantined']} migrations={st['migrations']}")
    fleet = gw.router.fleet
    print(f"fleet PTT updates: {fleet.updates}")
    print("TTFT rows (class x replica):")
    for c in range(fleet.num_classes):
        print(f"  class {c}: {np.round(fleet.table(c, fleet.TTFT), 4)}")
    return {"requests": reqs, "gateway": gw, "vocab": cfg.vocab}


if __name__ == "__main__":
    main()
