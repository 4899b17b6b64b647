"""Plain PyTorch version of flash attention: full materialized GQA
attention with a safe softmax — the math of the reference's
``repro/kernels/flash_attention/ref.py``.  The op runs it for CPU tensors;
on the card it is what the CUDA kernel is held against."""

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k,v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd) in
    ``q.dtype``.  Causal positions start at 0 on both sides."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qf = q.float().reshape(B, Hkv, rep, Sq, hd)
    s = torch.einsum("bgrqh,bgkh->bgrqk", qf, k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(Skv, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bgkh->bgrqh", p, v.float())
    return out.reshape(B, Hq, Sq, hd).to(q.dtype)
