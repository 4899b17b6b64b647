"""starcoder2-15b [dense] 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE [arXiv:2402.19173; hf].  LayerNorm + GELU + bias
(GPT-style trunk)."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152,
        qkv_bias=True, tie_embeddings=False, rope_theta=1e5,
        norm="layernorm", act="gelu")

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="starcoder2-15b-reduced", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=192, vocab=128,
        q_block=16, kv_block=16, compute_dtype="float32")
