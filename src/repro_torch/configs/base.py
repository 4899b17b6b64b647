"""Architecture configuration schema (the PyTorch port's copy of
``repro.configs.base``).

``input_specs`` is not carried over: it builds JAX ``ShapeDtypeStruct``
stand-ins and arrives with the dry-run port.  :func:`torch_dtype` maps the
``param_dtype`` / ``compute_dtype`` strings to torch dtypes."""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

Family = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    # attention / embedding details
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"
    causal: bool = True                  # False: encoder-only (audio)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                    # per-expert FFN hidden
    moe_every: int = 1                   # every n-th layer is MoE
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (jamba): 1 attention layer per `attn_every` layers
    attn_every: int = 0
    # vlm: cross-attention every n-th layer; image token count from frontend
    cross_attn_every: int = 0
    n_image_tokens: int = 1601
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # attention blocking for the pure-jnp flash path.  KV tiles are large
    # because the inner-scan carry (the f32 softmax accumulator) is saved
    # per KV step for autodiff: fewer steps = fewer saved carries.  The
    # Pallas flash kernel uses 512-tiles in real VMEM on TPU instead.
    q_block: int = 512
    kv_block: int = 2048
    # causal schedule: "blocked" computes all (q,k) tiles and masks;
    # "wrapped" pairs q-tiles (i, nq-1-i) so each pair sweeps exactly nq+1
    # k-tiles — the triangular flop skip, measured by the HLO walker
    causal_scheme: str = "blocked"
    # sequence-length cap for positional tables in decode caches
    max_seq_len: int = 32768

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, layer: int) -> bool:
        if self.n_experts == 0:
            return False
        return (layer % self.moe_every) == (self.moe_every - 1)

    def is_attn_layer(self, layer: int) -> bool:
        """hybrid (jamba): one attention layer per attn_every block."""
        if self.family != "hybrid":
            return True
        return layer % self.attn_every == 0

    def is_cross_layer(self, layer: int) -> bool:
        if self.cross_attn_every == 0:
            return False
        return (layer % self.cross_attn_every) == (self.cross_attn_every - 1)

    def param_count(self) -> int:
        """Total parameters (embedding + blocks + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        total = V * D                                   # embedding
        if not self.tie_embeddings:
            total += V * D                              # lm head
        for layer in range(L):
            if self.family in ("ssm",) or (self.family == "hybrid"
                                           and not self.is_attn_layer(layer)):
                di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
                conv_dim = di + 2 * ds                  # n_groups = 1
                total += D * (2 * di + 2 * ds + nh)     # in_proj
                total += conv_dim * self.ssm_conv + 3 * nh + di
                total += di * D                         # out_proj
            else:
                total += D * (Hq * hd) + 2 * D * (Hkv * hd) + (Hq * hd) * D
                if self.qkv_bias:
                    total += Hq * hd + 2 * Hkv * hd
            if self.is_moe_layer(layer):
                E, Fe = self.n_experts, self.d_expert
                total += D * E                          # router
                total += E * (3 * D * Fe)               # gate/up/down
            elif self.family == "ssm" or (self.family == "hybrid"
                                          and not self.is_attn_layer(layer)
                                          and self.n_experts > 0):
                pass                                    # mamba block has no FFN
            elif F > 0:
                n_mats = 3 if self.act == "silu" else 2
                total += n_mats * D * F
            total += 2 * D                              # norms
        total += D                                      # final norm
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if self.n_experts == 0:
            return self.param_count()
        E, Fe, k = self.n_experts, self.d_expert, self.top_k
        moe_layers = sum(self.is_moe_layer(l) for l in range(self.n_layers))
        inactive = moe_layers * (E - k) * 3 * self.d_model * Fe
        return self.param_count() - inactive


SHAPES: dict[str, dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def shape_skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    """Assignment rules: which (arch x shape) cells are skipped and why."""
    kind = SHAPES[shape]["kind"]
    if not cfg.causal and kind == "decode":
        return "encoder-only arch has no decode step"
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return None


#: The narrowest head the card's attention kernels take (ragged_decode and
#: ragged_prefill: 64 or 128; flash_attention: 64, 80 or 128).
CARD_HEAD_DIM = 64


def widen_heads(cfg: ModelConfig, hd: int = CARD_HEAD_DIM) -> ModelConfig:
    """``cfg`` with every head ``hd`` wide (``d_model = n_heads * hd``);
    depth, heads, MLP and vocab stay.  The reduced configs' heads are 4 to
    8 wide, narrower than any the card's attention kernels take; widened,
    the same small model runs on the CPU and on the card."""
    return dataclasses.replace(cfg, d_model=cfg.n_heads * hd, head_dim=0)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string (``param_dtype``,
    ``compute_dtype``)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r}; known: {tuple(_DTYPES)}") from None
