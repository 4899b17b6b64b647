"""smollm-135m [dense] 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense", n_layers=30, d_model=576,
        n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152,
        tie_embeddings=True, rope_theta=1e4, norm="rmsnorm", act="silu")

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="smollm-135m-reduced", n_layers=2, d_model=72,
        n_heads=9, n_kv_heads=3, d_ff=128, vocab=128,
        q_block=16, kv_block=16, compute_dtype="float32")
