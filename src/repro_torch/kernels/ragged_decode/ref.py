"""Plain PyTorch version of ragged decode attention: dense scores over the
whole cache with a per-slot validity mask — the math of the reference's
``repro/kernels/ragged_decode/ref.py``.  The op runs it for CPU tensors;
on the card it is what the CUDA kernel is held against."""

import math

import torch


def ragged_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor, *,
                      lse: bool = False):
    """q: (B, Hq, hd); k,v: (B, Smax, Hkv, hd); pos: (B,) int — the index
    of each slot's newest token (inclusive).  Returns (B, Hq, hd) float32,
    and with ``lse`` the (B, Hq) float32 log-sum-exp of each head's live
    scores.  A slot with no live row (``pos < 0``) gives 0 and -inf."""
    B, Hq, hd = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    qr = q.reshape(B, Hkv, rep, hd).float()
    s = torch.einsum("bgrh,bsgh->bgrs", qr, k_cache.float()) / math.sqrt(hd)
    valid = (torch.arange(Smax, device=q.device)[None, :]
             <= pos.to(q.device)[:, None])                   # (B, Smax)
    s = s.masked_fill(~valid[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    live = valid.any(-1)[:, None, None, None]                # (B, 1, 1, 1)
    p = torch.where(live, p, 0.0)
    out = torch.einsum("bgrs,bsgh->bgrh", p.to(v_cache.dtype).float(),
                       v_cache.float()).reshape(B, Hq, hd)
    if not lse:
        return out
    m = torch.where(live[..., 0], torch.logsumexp(s, dim=-1), float("-inf"))
    return out, m.reshape(B, Hq)
