"""Plain PyTorch version of chunked ragged prefill attention: dense scores
over the whole cache with per-slot causal and chunk-length masks — the
math of the reference's ``repro/kernels/ragged_prefill/ref.py``.  The op
runs it for CPU tensors; on the card it is what the CUDA kernel is held
against."""

import math

import torch


def ragged_prefill_ref(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, start: torch.Tensor,
                       qlen: torch.Tensor, *, lse: bool = False):
    """q: (B, T, Hq, hd) — chunk token ``i`` of slot ``b`` sits at absolute
    position ``start[b] + i`` and sees cache rows ``0 .. start[b] + i``;
    k,v: (B, Smax, Hkv, hd) caches already holding the chunk's own K/V
    rows; start, qlen: (B,) int.  Returns (B, T, Hq, hd) float32 with rows
    ``i >= qlen[b]`` exact zeros, and with ``lse`` the (B, T, Hq) float32
    log-sum-exp of each row's live scores.  A row that sees no cache row
    (``start[b] + i < 0``: a block of the cache wholly past it) and a
    padded row give 0 and -inf."""
    B, T, Hq, hd = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    dev = q.device
    qr = q.reshape(B, T, Hkv, rep, hd).float()
    s = torch.einsum("btgrh,bsgh->btgrs", qr, k_cache.float()) / math.sqrt(hd)
    qpos = (start.to(dev).long()[:, None]
            + torch.arange(T, device=dev)[None, :])            # (B, T)
    causal = torch.arange(Smax, device=dev)[None, None, :] <= qpos[:, :, None]
    s = s.masked_fill(~causal[:, :, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    valid = torch.arange(T, device=dev)[None, :] < qlen.to(dev)[:, None]
    live = (valid & (qpos >= 0))[:, :, None, None]             # (B, T, 1, 1)
    out = torch.einsum("btgrs,bsgh->btgrh", p.to(v_cache.dtype).float(),
                       v_cache.float()).reshape(B, T, Hq, hd)
    out = out.masked_fill(~live, 0.0)
    if not lse:
        return out
    m = torch.where(live[..., 0], torch.logsumexp(s, dim=-1).reshape(
        B, T, Hq), float("-inf"))
    return out, m
