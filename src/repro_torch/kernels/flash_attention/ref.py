"""Plain PyTorch versions of flash attention: full materialized GQA
attention with a safe softmax — the math of the reference's
``repro/kernels/flash_attention/ref.py`` — and, for training, the same
forward with each row's log-sum-exp and the backward's equations.  The op
runs them for CPU tensors; on the card they are what the CUDA kernels are
held against.

The log-sum-exp is in natural-log units: ``lse[b, h, i] = ln(sum_j
exp(scale * q_i . k_j))`` over the keys row ``i`` sees, float32 (B, Hq,
Sq), the unit ``csrc/flash_attention.cu`` writes and
``csrc/flash_attention_bwd.cu`` reads."""

import math

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """float32 scores ``scale * q k^T``, (B, Hkv, rep, Sq, Skv), -1e30
    above the diagonal when causal."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, hd)
    s = torch.einsum("bgrqh,bgkh->bgrqk", qf, k.float()) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(~_mask(Sq, Skv, q.device), -1e30)
    return s


def _mask(Sq: int, Skv: int, device) -> torch.Tensor:
    """True where query i sees key j: j <= i (positions from 0)."""
    return (torch.arange(Skv, device=device)[None, :]
            <= torch.arange(Sq, device=device)[:, None])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k,v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd) in
    ``q.dtype``.  Causal positions start at 0 on both sides."""
    return _out(torch.softmax(_scores(q, k, causal), dim=-1), v, q)


def _out(p: torch.Tensor, v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    out = torch.einsum("bgrqk,bgkh->bgrqh", p, v.float())
    return out.reshape(q.shape).to(q.dtype)


def attention_ref_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True):
    """:func:`attention_ref` and each row's log-sum-exp: (out (B, Hq, Sq,
    hd) in ``q.dtype``, lse (B, Hq, Sq) float32)."""
    s = _scores(q, k, causal)
    return (_out(torch.softmax(s, dim=-1), v, q),
            torch.logsumexp(s, dim=-1).reshape(q.shape[:3]))


def attention_ref_backward(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           dO: torch.Tensor, lse: torch.Tensor, *,
                           causal: bool = True):
    """The gradient of :func:`attention_ref` from the forward's output
    ``o``, the output's gradient ``dO`` and the rows' ``lse``, by the
    kernel's equations in float32: ``D = rowsum(dO * o)``, ``P = exp(scale
    q k^T - lse)`` (0 above the diagonal when causal), ``dV = P^T dO``,
    ``dS = P * (dO v^T - D)``, ``dQ = scale dS k``, ``dK = scale dS^T q``,
    the GQA group's query heads summed into their kv head.  Returns (dq,
    dk, dv) in the dtypes of q, k, v."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    grp = lambda t: t.float().reshape(B, Hkv, rep, Sq, hd)
    qf, of, dof = grp(q), grp(o), grp(dO)
    kf, vf = k.float(), v.float()
    p = torch.exp(torch.einsum("bgrqh,bgkh->bgrqk", qf, kf) * scale
                  - lse.float().reshape(B, Hkv, rep, Sq, 1))
    if causal:
        p = p.masked_fill(~_mask(Sq, Skv, q.device), 0.0)
    D = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bgrqk,bgrqh->bgkh", p, dof)
    ds = p * (torch.einsum("bgrqh,bgkh->bgrqk", dof, vf) - D)
    dq = torch.einsum("bgrqk,bgkh->bgrqh", ds, kf) * scale
    dk = torch.einsum("bgrqk,bgrqh->bgkh", ds, qf) * scale
    return (dq.reshape(B, Hq, Sq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
