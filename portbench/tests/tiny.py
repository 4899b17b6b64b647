"""Tiny cells for the CPU tests: the drivers run as on the card, on the
port's reduced configurations with 64-wide heads (the widths every
attention kernel takes), on the CPU (each kernel's plain version), with
short windows and light traffic."""

from __future__ import annotations

import copy
import time

import torch

from portbench.lib import cell
from portbench.lib import model as M



def port_and_dims(config: str):
    from repro_torch.configs import get_config, widen_heads
    cfg = widen_heads(get_config(config, reduced=True))
    d = M.Dims(family=cfg.family, L=cfg.n_layers, D=cfg.d_model,
               Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, hd=cfg.hd,
               F=0 if cfg.family == "moe" else cfg.d_ff, V=cfg.vocab,
               tied=cfg.tie_embeddings, qkv_bias=cfg.qkv_bias,
               theta=cfg.rope_theta, eps=1e-6, E=cfg.n_experts, k=cfg.top_k,
               Fe=cfg.d_expert, capacity_factor=cfg.capacity_factor)
    return cfg, d


# an open loop (``serve_open``) of chat-like lengths on the reduced qwen2:
# no cell of BENCHMARK.json runs one yet, and these tests keep the driver
# ready for a later cell that adds only its traffic and limits files
OPEN_LOOP = {"kind": "serve_open", "rate": 3.0,
             "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.8},
             "output": {"dist": "lognormal", "median": 12, "sigma": 0.8},
             "engine": {"max_batch": 4, "max_seq": 128, "decode_chunk": 4,
                        "prefill_chunk_tokens": 16}}
OPEN_LIMITS = {"logit_gap": 0.05, "unserved": 0}


def _tiny(cell_name, conf, traffic, limits, seed, seconds, trace,
          traffic_over) -> cell.Context:
    traffic = copy.deepcopy(traffic)
    cfg, d = port_and_dims(conf["port_config"])
    eng = traffic["engine"]
    eng.update(max_batch=4, max_seq=128)
    if eng.get("prefill_chunk_tokens"):
        eng["prefill_chunk_tokens"] = 16
    for key in ("prompt", "output"):
        if key in traffic:
            traffic[key] = dict(traffic[key], min=4, max=40, median=12)
    # light enough that a CPU shared with other test workers keeps up; the
    # drain waits as long as such a CPU may need
    traffic.update(rate=3.0, warmup_s=0.5, drain_s=300, trace_slice_s=0.5,
                   check_requests=4, queue=4, pool=256)
    traffic.update(traffic_over)
    return cell.Context(cell=cell_name, conf=conf, traffic=traffic,
                        limits=limits, dims=d, seed=seed, seconds=seconds,
                        trace=trace, device=torch.device("cpu"),
                        t_start=time.perf_counter(), port_cfg=cfg)


def context(cell_name: str, seed: int = 7, seconds: float = 1.5,
            trace: bool = False, **traffic_over) -> cell.Context:
    """A ``cell.Context`` for ``cell_name``'s driver at a tiny size."""
    work, conf, traffic, limits = cell.load_cell(cell_name)
    return _tiny(cell_name, conf, traffic, limits, seed, seconds, trace,
                 traffic_over)


def open_context(seed: int = 7, seconds: float = 1.5, trace: bool = False,
                 **traffic_over) -> cell.Context:
    """A ``cell.Context`` of ``OPEN_LOOP`` on the reduced qwen2."""
    return _tiny("open-loop", M.load_config("qwen2-0.5b"), OPEN_LOOP,
                 OPEN_LIMITS, seed, seconds, trace, traffic_over)


def train_context(seed: int = 7, seconds: float = 1.0,
                  trace: bool = False) -> cell.Context:
    """The training cell at the reduced qwen2, a 2 x 32 batch."""
    work, conf, traffic, limits = cell.load_cell("qwen2-train")
    traffic = dict(copy.deepcopy(traffic), batch=2, seq=32,
                   trace_slice_s=0.3, compare_at=4)
    cfg, d = port_and_dims(conf["port_config"])
    return cell.Context(cell="qwen2-train", conf=conf, traffic=traffic,
                        limits=limits, dims=d, seed=seed, seconds=seconds,
                        trace=trace, device=torch.device("cpu"),
                        t_start=time.perf_counter(), port_cfg=cfg)
