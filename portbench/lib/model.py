"""A configuration file's sizes (``portbench/configs/<name>.json``, the
published ``config.json`` keys as run), and the weights the benchmark makes
from ``--seed`` for both the program and the reference."""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The query and key projections are drawn QK_GAIN times wider than the
# others.  At 1/sqrt(fan-in) a random model's attention is near uniform,
# every position's state collapses to one, and greedy decoding repeats one
# token whatever the prompt; peaked attention, as a trained model's, keeps
# the served tokens depending on the context, which is what the comparison
# with the reference needs.  At 4 the model turns chaotic: bfloat16's
# rounding alone moves its tokens as far as float8's (PERF.md).
QK_GAIN = 3.0


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str
    L: int
    D: int
    Hq: int
    Hkv: int
    hd: int
    F: int
    V: int
    tied: bool
    qkv_bias: bool
    theta: float
    eps: float
    E: int = 0
    k: int = 0
    Fe: int = 0
    capacity_factor: float = 0.0


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def dims(conf: dict) -> Dims:
    moe = conf["family"] == "moe"
    return Dims(
        family=conf["family"], L=conf["num_hidden_layers"],
        D=conf["hidden_size"], Hq=conf["num_attention_heads"],
        Hkv=conf["num_key_value_heads"], hd=conf["head_dim"],
        F=0 if moe else conf["intermediate_size"], V=conf["vocab_size"],
        tied=conf["tie_word_embeddings"], qkv_bias=conf["qkv_bias"],
        theta=float(conf["rope_theta"]), eps=conf["rms_norm_eps"],
        E=conf.get("num_local_experts", 0),
        k=conf.get("num_experts_per_tok", 0),
        Fe=conf["intermediate_size"] if moe else 0,
        capacity_factor=conf.get("moe_prefill_capacity_factor", 0.0))


def leaf_specs(d: Dims) -> list[tuple[tuple[str, ...], tuple, str, float]]:
    """Every parameter as ``(path, shape, kind, scale)`` in the order they
    are drawn: the per-layer leaves stacked on the layer axis, projections
    ``(in, out)``.  ``kind``: ``normal`` (N(0, 1) x scale), ``uniform``
    (U(-scale, scale)) or ``one`` (1 + U(-scale, scale): norm scales)."""
    L, D, hd = d.L, d.D, d.hd
    q, kv = d.Hq * hd, d.Hkv * hd
    out = [(("tok", "embed"), (d.V, D), "normal", 0.02)]
    if not d.tied:
        out.append((("tok", "lm_head"), (D, d.V), "uniform", D ** -0.5))
    lay = "layers"
    qk = QK_GAIN * D ** -0.5
    out += [((lay, "ln1", "scale"), (L, D), "one", 0.1),
            ((lay, "attn", "wq"), (L, D, q), "uniform", qk),
            ((lay, "attn", "wk"), (L, D, kv), "uniform", qk),
            ((lay, "attn", "wv"), (L, D, kv), "uniform", D ** -0.5),
            ((lay, "attn", "wo"), (L, q, D), "uniform", q ** -0.5)]
    if d.qkv_bias:
        out += [((lay, "attn", "bq"), (L, q), "uniform", qk),
                ((lay, "attn", "bk"), (L, kv), "uniform", qk),
                ((lay, "attn", "bv"), (L, kv), "uniform", D ** -0.5)]
    out.append(((lay, "ln2", "scale"), (L, D), "one", 0.1))
    if d.family == "moe":
        E, Fe = d.E, d.Fe
        out += [((lay, "moe", "router"), (L, D, E), "uniform", D ** -0.5),
                ((lay, "moe", "w_gate"), (L, E, D, Fe), "uniform", D ** -0.5),
                ((lay, "moe", "w_up"), (L, E, D, Fe), "uniform", D ** -0.5),
                ((lay, "moe", "w_down"), (L, E, Fe, D), "uniform",
                 Fe ** -0.5)]
    else:
        out += [((lay, "mlp", "w_gate"), (L, D, d.F), "uniform", D ** -0.5),
                ((lay, "mlp", "w_up"), (L, D, d.F), "uniform", D ** -0.5),
                ((lay, "mlp", "w_down"), (L, d.F, D), "uniform",
                 d.F ** -0.5)]
    out.append((("ln_f", "scale"), (D,), "one", 0.1))
    return out


def make_weights(d: Dims, seed: int, device) -> dict:
    """The float32 weights of ``seed`` as a nested dict (the port's
    parameter tree, ``repro_torch.models.convert.param_tree``'s layout),
    drawn on ``device`` by one generator, one call a stacked leaf.  Norm
    scales and QKV biases are drawn too, not left at 1 and 0, so that the
    comparison sees them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    tree: dict = {}
    for path, shape, kind, scale in leaf_specs(d):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if kind == "normal":
            t.normal_(generator=gen).mul_(scale)
        else:
            t.uniform_(-scale, scale, generator=gen)
            if kind == "one":
                t.add_(1.0)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def n_params(d: Dims) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaf_specs(d))
