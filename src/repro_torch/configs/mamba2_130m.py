"""mamba2-130m [ssm] 24L d_model=768 (attn-free) vocab=50280, ssm_state=128
— SSD (state-space duality) [arXiv:2405.21060].  d_inner=1536, 24 heads of
head_dim 64, conv4, chunked scan length 256."""
import dataclasses
from .base import ModelConfig

def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=256, norm="rmsnorm", max_seq_len=524288)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(), name="mamba2-130m-reduced", n_layers=2, d_model=64,
        n_heads=1, n_kv_heads=1, vocab=128, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, compute_dtype="float32")
