"""jamba-v0.1-52b [hybrid] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave [arXiv:2403.19887].
SSM layers use the Mamba2/SSD chunked formulation (TPU-native adaptation of
Jamba's Mamba-1 layers; see DESIGN.md).  MoE every 2nd layer (d_ff is both
the dense-MLP and per-expert hidden, as in Jamba)."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
        n_experts=16, top_k=2, d_expert=14336, moe_every=2, attn_every=8,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=256, norm="rmsnorm", act="silu", max_seq_len=524288)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="jamba-v0.1-52b-reduced", n_layers=8, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab=128, n_experts=4, top_k=2,
        d_expert=96, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        q_block=16, kv_block=16, compute_dtype="float32")
