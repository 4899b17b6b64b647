"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
Every layer MoE; d_ff is the per-expert hidden."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
        n_experts=32, top_k=8, d_expert=512, moe_every=1,
        rope_theta=1e4, norm="rmsnorm", act="silu")

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="granite-moe-1b-a400m-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=32, vocab=128, n_experts=8, top_k=2,
        d_expert=32, q_block=16, kv_block=16, compute_dtype="float32")
