"""Roofline model of one NVIDIA H100 SXM: the port's counterpart of
``repro/distributed/roofline.py``, whose constants were a TPU v5e's.

Terms (per device, from the cost counter's totals, ``distributed.cost``):

    compute    = FLOPs_dev / PEAK_FLOPS
    memory     = bytes_dev / HBM_BW
    collective = wire_bytes_ici / NVLINK_BW + wire_bytes_dcn / NETWORK_BW

plus MODEL_FLOPS (6 N_active tokens for training, 2 N_active tokens for
inference) and the usefulness ratio MODEL_FLOPS / (FLOPs_dev * chips).
The record keeps the reference's keys: ``wire_ici`` is the traffic inside
a pod (NVLink here), ``wire_dcn`` the traffic that crosses pods (the
network here), and ``t_collective`` their sum in time.

:func:`model_flops` and :func:`analytic_decode_bytes` depend on the
configuration alone and equal the reference's; :func:`model_flops_for`
and :func:`decode_bytes_for` take the batch and sequence themselves, so a
measured cell on the card is priced the same way.
"""

from __future__ import annotations

import dataclasses

from ..configs.base import SHAPES, ModelConfig

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet): dense BF16
# Tensor Core peak (the 1,979 TFLOP/s of the sheet is with sparsity)
PEAK_FLOPS = 989e12          # bf16 FLOP/s
PEAK_FLOPS_F32 = 67e12       # FP32 FLOP/s (same datasheet, SXM column)
HBM_BW = 3.35e12             # HBM3 bytes/s (same datasheet)
# fourth-generation NVLink, 900 GB/s a GPU both ways: 450 GB/s a direction
NVLINK_BW = 450e9            # bytes/s inside a pod
# one NDR InfiniBand port of 400 Gb/s a GPU between pods (the datasheet's
# HGX H100 networking): 50 GB/s
NETWORK_BW = 50e9            # bytes/s a GPU across pods


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_dev: float
    bytes_dev: float
    coll_operand_bytes: float
    wire_ici: float
    wire_dcn: float
    model_flops: float
    peak_mem_bytes: int

    @property
    def t_compute(self) -> float:
        return self.flops_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_ici / NVLINK_BW + self.wire_dcn / NETWORK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step-time estimate: the dominant term bounds the step
        (assuming perfect overlap of the other two)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_dev * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the hardware roofline achieved on *useful* model
        FLOPs: useful_time_at_peak / bound_step_time."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        return t_useful / self.step_time if self.step_time else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_dev": self.flops_dev, "bytes_dev": self.bytes_dev,
            "coll_operand_bytes": self.coll_operand_bytes,
            "wire_ici": self.wire_ici, "wire_dcn": self.wire_dcn,
            "model_flops": self.model_flops,
            "peak_mem_bytes": self.peak_mem_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "step_time": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def decode_bytes_for(cfg: ModelConfig, batch: int, seq: int,
                     chips: int) -> float:
    """Per-device HBM bytes of one decode step of ``batch`` sequences
    against a ``seq``-long cache: all (bf16) weights read once + the
    KV / SSM state read once (a token slice's write is not counted)."""
    B, S = batch, seq
    params = cfg.param_count() * 2                    # bf16 serving weights
    cache = 0.0
    for layer in range(cfg.n_layers):
        if cfg.family in ("ssm",) or (cfg.family == "hybrid"
                                      and not cfg.is_attn_layer(layer)):
            cache += (B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                      * 4)                            # f32 SSM state
            cache += B * (cfg.ssm_conv - 1) * (cfg.d_inner
                                               + 2 * cfg.ssm_state) * 2
        else:
            cache += 2 * B * S * cfg.n_kv_heads * cfg.hd * 2   # K+V bf16
    if cfg.family == "vlm":
        nb = cfg.n_layers // cfg.cross_attn_every
        cache += 2 * nb * B * cfg.n_image_tokens * cfg.n_kv_heads * cfg.hd * 2
    return (params + cache) / chips


def analytic_decode_bytes(cfg: ModelConfig, shape: str, chips: int) -> float:
    """:func:`decode_bytes_for` at a shape cell's batch and sequence."""
    s = SHAPES[shape]
    return decode_bytes_for(cfg, s["global_batch"], s["seq_len"], chips)


def model_flops_for(cfg: ModelConfig, kind: str, batch: int,
                    seq: int) -> float:
    """6 N_active tokens (train), 2 N_active tokens (prefill), 2 N_active
    a sequence (decode: one token each)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    return 2.0 * n_active * batch


def model_flops(cfg: ModelConfig, shape: str) -> float:
    s = SHAPES[shape]
    return model_flops_for(cfg, s["kind"], s["global_batch"], s["seq_len"])


def build_from_walker(arch: str, shape: str, mesh_name: str, chips: int,
                      totals, cfg: ModelConfig, peak_mem_bytes: int,
                      model_flops_value: float | None = None) -> Roofline:
    """Roofline from the cost counter's totals (``cost.CostTotals``; the
    reference reads its HLO walker's, hence the name).  ``shape`` names a
    cell of ``SHAPES``, or, with ``model_flops_value``, any cell."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_dev=float(totals.flops),
        bytes_dev=float(totals.bytes),
        coll_operand_bytes=float(totals.coll_operand),
        wire_ici=float(totals.wire_ici),
        wire_dcn=float(totals.wire_dcn),
        model_flops=(model_flops(cfg, shape) if model_flops_value is None
                     else model_flops_value),
        peak_mem_bytes=peak_mem_bytes)


def build(arch: str, shape: str, mesh_name: str, chips: int, cost: dict,
          ops: list, cfg: ModelConfig, peak_mem_bytes: int) -> Roofline:
    """The reference's ``build``: ``cost`` with ``"flops"`` and ``"bytes
    accessed"``, ``ops`` the collectives (``cost.CollectiveOp``)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_dev=float(cost.get("flops", 0.0)),
        bytes_dev=float(cost.get("bytes accessed", 0.0)),
        coll_operand_bytes=float(sum(o.operand_bytes for o in ops)),
        wire_ici=sum(o.wire_bytes() for o in ops if not o.cross_pod),
        wire_dcn=sum(o.wire_bytes() for o in ops if o.cross_pod),
        model_flops=model_flops(cfg, shape),
        peak_mem_bytes=peak_mem_bytes)
