"""Serve a small model with batched requests through the continuous-batching
engine; the PTT-backed elastic scheduler handles prefill (critical) and
decode (non-critical) placement.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The port's counterpart of ``examples/serve_lm.py``: the same reduced
config, slots and traffic.  The weights are drawn on the device from a
``torch.Generator`` seeded with 0, so the streams are not the JAX
example's.  The reduced config's heads are widened to 64, the narrowest
the card's attention kernels take (:func:`example_config`), on every
device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, widen_heads
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine


def example_config(arch: str):
    """The reference example's reduced config with its heads widened to 64
    (:func:`repro_torch.configs.widen_heads`)."""
    return widen_heads(get_config(arch, reduced=True))


def init_params(model, device, seed: int = 0):
    """The model's parameters drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return model.init(gen, device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = example_config("qwen2-0.5b")
    m = get_model(cfg)
    params = init_params(m, dev)
    engine = ServeEngine(m, params, max_batch=4, max_seq=48)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 12), max_new=8)
            for i in range(8)]
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new/dt:.1f} tok/s, {dev})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt={r.prompt[:6].tolist()}... "
              f"-> {r.out_tokens}")
    print(f"PTT updates observed by the serve scheduler: "
          f"{engine.scheduler.ptt.updates}")
    return {"requests": reqs, "engine": engine, "vocab": cfg.vocab}


if __name__ == "__main__":
    main()
