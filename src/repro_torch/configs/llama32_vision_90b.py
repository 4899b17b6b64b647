"""llama-3.2-vision-90b [vlm] 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-Vision family].  Vision frontend is a STUB:
input_specs provides precomputed patch embeddings (B, 1601, d_model)."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
        cross_attn_every=5, n_image_tokens=1601,
        rope_theta=5e5, norm="rmsnorm", act="silu",
        # larger KV tiles bound the jnp-flash backward carries (the Pallas
        # kernel replaces this path on real TPU; see EXPERIMENTS.md §Perf)
        q_block=512, kv_block=2048)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="llama-3.2-vision-90b-reduced", n_layers=10,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
        n_image_tokens=9, q_block=16, kv_block=16, compute_dtype="float32")
