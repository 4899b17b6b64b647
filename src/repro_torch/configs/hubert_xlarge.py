"""hubert-xlarge [audio] 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 — encoder-only [arXiv:2106.07447].  The convolutional audio
frontend is a STUB: input_specs provides precomputed frame embeddings
(B, T, d_model); the backbone is the standard transformer encoder with a
504-way masked-prediction head.  No decode cells (encoder-only)."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504,
        causal=False, norm="layernorm", act="gelu", qkv_bias=True)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="hubert-xlarge-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=64,
        q_block=16, kv_block=16, compute_dtype="float32")
