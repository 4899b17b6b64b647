"""Model FLOPs of the work a window did, from the shapes of its calls (a
``lib.model.Dims``).  A product of an ``m x n`` and an ``n x p`` matrix is
``2 m n p`` operations.  The embedding lookup is no product; the head is.
An MoE token counts its ``k`` experts and the router, never the experts it
skipped.  Attention counts ``4 x Hq x hd`` a (query, key) pair a layer
(the scores and the weighted values)."""

from __future__ import annotations


def layer_matrix_weights(d) -> int:
    """Weights of one layer's products that one token uses."""
    attn = d.D * (d.Hq + 2 * d.Hkv) * d.hd + d.Hq * d.hd * d.D
    if d.family == "moe":
        return attn + d.D * d.E + d.k * 3 * d.D * d.Fe
    return attn + 3 * d.D * d.F


def head_weights(d) -> int:
    return d.D * d.V


def token_flops(d, keys: int) -> float:
    """One token through every layer, attending to ``keys`` positions,
    without the head."""
    return d.L * (2.0 * layer_matrix_weights(d) + 4.0 * d.Hq * d.hd * keys)


def decode_flops(d, slots) -> float:
    """Decode steps of slots given as ``(p, n)``: ``n`` steps from decode
    position ``p``, step ``i`` attending to ``p + i + 1`` keys and running
    the head."""
    return sum(token_flops(d, p + i + 1) + 2.0 * head_weights(d)
               for p, n in slots for i in range(n))


def causal_pairs(start: int, qlen: int) -> int:
    """(query, key) pairs of ``qlen`` queries at ``start..`` over every
    key up to each."""
    return qlen * start + qlen * (qlen + 1) // 2


def prefill_flops(d, start: int, qlen: int) -> float:
    """A prompt chunk (or a whole prompt, ``start`` 0): its tokens through
    every layer and the head on its last token."""
    return (d.L * (2.0 * layer_matrix_weights(d) * qlen
                   + 4.0 * d.Hq * d.hd * causal_pairs(start, qlen))
            + 2.0 * head_weights(d))


def train_flops(d, batch: int, seq: int) -> float:
    """One training step: 6 a weight of every product a token (forward
    and backward; the head is the tied embedding's product, counted once),
    and 3 x the attention's forward (12 x Hq x hd a causal pair a layer).
    The recompute of checkpointed layers is not counted."""
    n_mm = d.L * layer_matrix_weights(d) + head_weights(d)
    attn = d.L * 12.0 * batch * d.Hq * d.hd * causal_pairs(0, seq)
    return 6.0 * n_mm * batch * seq + attn
