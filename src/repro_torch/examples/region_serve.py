"""Cross-region serving walkthrough: a RegionGateway fronts two fleets
(each a real FleetGateway over ServeEngine replicas) with WAN-aware
routing, then browns out the loaded fleet — its live sessions drain to
the healthy fleet through the versioned session wire format and continue
decoding.

    PYTHONPATH=src python -m repro_torch.examples.region_serve [--device cpu]

The port's counterpart of ``examples/region_serve.py``: the same reduced
config, fleets, link and traffic; weights drawn on the device from seed 0,
heads widened to 64 (``serve_lm.example_config``).
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.examples.serve_lm import example_config, init_params
from repro_torch.models import get_model
from repro_torch.region import LoopbackTransport, RegionGateway, RegionRouter
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
    fleets = [FleetGateway([ServeEngine(m, params, max_batch=2, max_seq=48)
                            for _ in range(2)]) for _ in range(2)]
    rg = RegionGateway(fleets, router=RegionRouter(2),
                       transport=LoopbackTransport(
                           link_rtt=lambda s, d: 0.08))

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 6), max_new=10)
            for i in range(4)]
    for r in reqs:
        d = rg.submit(r, origin=0, affinity=0)
        print(f"req {r.rid}: class={d.req_class.name} -> fleet {d.fleet} "
              f"(wan_hop={d.wan_hop}, predicted={d.predicted:.3f}s)")

    for _ in range(3):                 # get decode sessions in flight
        rg.pump()
    print("\nregion-wide brownout of fleet 0: draining live sessions "
          "cross-region over the wire ...")
    rg.brownout(0)
    rg.pump()
    st = rg.stats()
    print(f"shipped {st['wan_ships']} sessions "
          f"({st['wan_bytes']} wire bytes, "
          f"{st['raw_session_bytes']} raw cache bytes); "
          f"learned 0->1 RTT row: {st['rtt_rows'][0][1]:.3f}s")

    rg.run_until_drained()
    print(f"\nTTFT per request (s, {dev}):")
    handles = {}
    for rid, ttft in sorted(rg.ttfts().items()):
        handle = handles[rid] = rg.request(rid)
        moved = "migrated" if handle is not reqs[rid] else "stayed"
        print(f"  req {rid}: {ttft:.3f}  [{moved}] "
              f"tokens={handle.out_tokens}")
    st = rg.stats()
    print(f"\nfleet_served={st['fleet_served']} "
          f"stay_home_skips={st['stay_home_skips']} "
          f"browned_out={st['browned_out']}")
    return {"requests": handles, "gateway": rg, "stats": st,
            "vocab": cfg.vocab}


if __name__ == "__main__":
    main()
