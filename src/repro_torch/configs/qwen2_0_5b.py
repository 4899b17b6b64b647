"""qwen2-0.5b [dense] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936
— GQA, QKV bias [arXiv:2407.10671; hf].  Tied embeddings (0.5B ties)."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense", n_layers=24, d_model=896,
        n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
        norm="rmsnorm", act="silu")

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen2-0.5b-reduced", n_layers=2, d_model=56,
        n_heads=14, n_kv_heads=2, d_ff=96, vocab=128,
        q_block=16, kv_block=16, compute_dtype="float32")
