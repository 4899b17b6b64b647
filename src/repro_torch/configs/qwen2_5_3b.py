"""qwen2.5-3b [dense] 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA, QKV bias [hf:Qwen/Qwen2.5 family; hf]."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
        norm="rmsnorm", act="silu")

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen2.5-3b-reduced", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=128, vocab=128,
        q_block=16, kv_block=16, compute_dtype="float32")
