"""qwen3-moe-235b-a22b [moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3 family; hf].  Every layer MoE;
d_ff is the per-expert hidden; QK-norm and head_dim=128 per the Qwen3
family."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
        n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128,
        qk_norm=True, n_experts=128, top_k=8, d_expert=1536, moe_every=1,
        rope_theta=1e6, norm="rmsnorm", act="silu")

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen3-moe-235b-a22b-reduced", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=4, d_ff=32, vocab=128, head_dim=16,
        n_experts=8, top_k=2, d_expert=32,
        q_block=16, kv_block=16, compute_dtype="float32")
