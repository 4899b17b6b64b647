"""Carry parameters between the JAX package's tree and the port's modules.

:func:`params_from_numpy` takes the reference's parameter tree with every
leaf a numpy array (``jax.tree.map(np.asarray, params)``) or a tensor (what
:func:`repro_torch.checkpoint.load_checkpoint` returns): a nested dict
whose per-layer leaves are stacked on leading layer axes and whose weights
are ``(in, out)``.  The port keeps the ``(in, out)`` layout, so carrying a
layer over is slicing it off those axes.  :func:`params_to_numpy` is its
inverse: the port's modules as that tree, per-layer tensors stacked back,
under the reference's key names and in its ``param_dtype``, so a
checkpoint the port writes loads through the JAX package's
``load_checkpoint(target_tree=init(...))``.  Both import nothing of JAX.

The trees, by family:

* dense, MoE (``moe_every == 1``), SSM: ``tok``, ``layers`` (every leaf
  stacked on ``L``: ``ln1`` / ``attn`` / ``ln2`` / ``mlp`` or ``moe``, or
  for the SSM ``ln`` / ``ssm``) and ``ln_f``;
* MoE at ``moe_every > 1``: ``tok``, ``dense_layers`` stacked on ``(nb,
  per_d)`` (``ln1`` / ``attn`` / ``ln2`` / ``mlp``), ``moe_layers`` on
  ``(nb,)`` (``ln1`` / ``attn`` / ``ln2`` / ``moe``) and ``ln_f``;
* audio: the dense tree (LayerNorm biases, qkv and MLP biases) and
  ``head`` (D, vocab);
* hybrid: ``tok``, ``attn_layers`` stacked on ``(nb,)``, ``mamba_moe`` on
  ``(nb, 4)``, ``mamba_dense`` on ``(nb, 3)`` (``ln1`` / ``ssm`` / ``ln2``
  / ``moe`` or ``mlp``) and ``ln_f``;
* vlm: ``tok``, ``self_layers`` stacked on ``(nb, per_self)`` (``ln1`` /
  ``attn`` / ``ln2`` / ``mlp``), ``cross_layers`` on ``(nb,)`` (``ln1`` /
  ``xattn`` / ``gate_attn`` / ``ln2`` / ``mlp`` / ``gate_mlp``, the gates
  scalars) and ``ln_f``.

Layer ``(b, i)`` of a stack on ``(nb, n)`` is the module at ``blocks[b]``,
position ``i``, and is stacked back in that order.

The port's modules carry the reference's names for their tensors and
sub-modules, so :func:`params_to_numpy` reads a layer's tree off the
module itself (:func:`_module_tree`), and :func:`param_tree` /
:func:`bind_params` carry a model to and from that tree on the device: the
trainer keeps its float32 master weights and AdamW state in it, as the
reference does.  :func:`train_state_from_numpy` and
:func:`train_state_to_numpy` carry a whole training state across, so a
JAX training checkpoint resumes in the port and the other way round.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..checkpoint.store import device_leaf, host_leaf
from ..configs.base import ModelConfig, torch_dtype
from ..device import resolve_device
from ..distributed import tp
from ..tree import tree_map
from . import jamba, moe, vlm
from . import layers as L
from .mamba2 import SSM, SSM_AXES, SSMLayer
from .moe import MoE, MoEBlock
from .transformer import Block, Transformer


def _take(tree: dict, idx) -> dict:
    """Every leaf of a nested dict indexed by ``idx``."""
    return {k: _take(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def _alternating(cfg: ModelConfig) -> bool:
    return cfg.family == "moe" and cfg.moe_every > 1


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None
                      ) -> Transformer | moe.AlternatingMoE | jamba.Jamba \
        | vlm.VLM:
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def ts(d: dict) -> dict:
        return {k: t(v) for k, v in d.items()}

    def norm(d: dict) -> L.Norm:
        return L.Norm(t(d["scale"]), t(d["bias"]) if "bias" in d else None)

    def ffn(d: dict):
        return MoE(cfg, ts(d["moe"])) if "moe" in d else L.MLP(cfg,
                                                              ts(d["mlp"]))

    def attn_layer(d: dict):
        cls = MoEBlock if "moe" in d else Block
        return cls(norm(d["ln1"]), L.Attention(cfg, ts(d["attn"])),
                   norm(d["ln2"]), ffn(d))

    def mamba_layer(d: dict) -> jamba.MambaBlock:
        return jamba.MambaBlock(norm(d["ln1"]), SSM(cfg, ts(d["ssm"])),
                                norm(d["ln2"]), ffn(d))

    tok = tree["tok"]
    embed = L.Embedding(cfg, t(tok["embed"]),
                        t(tok["lm_head"]) if "lm_head" in tok else None)
    ln_f = norm(tree["ln_f"])
    if cfg.family == "hybrid":
        blocks = [jamba.SuperBlock(
            attn_layer(_take(tree["attn_layers"], b)),
            [mamba_layer(_take(tree["mamba_moe"], (b, i)))
             for i in range(jamba.N_MOE)],
            [mamba_layer(_take(tree["mamba_dense"], (b, i)))
             for i in range(jamba.N_DENSE)])
            for b in range(cfg.n_layers // cfg.attn_every)]
        return jamba.Jamba(embed, blocks, ln_f)
    if cfg.family == "vlm":
        nb, per_self = vlm.layout(cfg)

        def cross_layer(d: dict) -> vlm.CrossBlock:
            return vlm.CrossBlock(norm(d["ln1"]),
                                  L.Attention(cfg, ts(d["xattn"])),
                                  t(d["gate_attn"]), norm(d["ln2"]),
                                  L.MLP(cfg, ts(d["mlp"])), t(d["gate_mlp"]))
        blocks = [vlm.SuperBlock(
            [attn_layer(_take(tree["self_layers"], (b, i)))
             for i in range(per_self)],
            cross_layer(_take(tree["cross_layers"], b))) for b in range(nb)]
        return vlm.VLM(embed, blocks, ln_f)
    if _alternating(cfg):
        nb, per_d = moe.layout(cfg)
        blocks = [moe.SuperBlock(
            [attn_layer(_take(tree["dense_layers"], (b, i)))
             for i in range(per_d)],
            attn_layer(_take(tree["moe_layers"], b))) for b in range(nb)]
        return moe.AlternatingMoE(embed, blocks, ln_f)
    lay = tree["layers"]
    if cfg.family == "ssm":
        layers = [SSMLayer(norm(_take(lay["ln"], i)),
                           SSM(cfg, ts(_take(lay["ssm"], i))))
                  for i in range(cfg.n_layers)]
    else:
        layers = [attn_layer(_take(lay, i)) for i in range(cfg.n_layers)]
    return Transformer(embed, layers, ln_f,
                       t(tree["head"]) if cfg.family == "audio" else None)


def _module_tree(m: nn.Module, leaf=lambda t: t) -> dict:
    """A module's tensors (each through ``leaf``) and sub-modules as a
    nested dict under their attribute names (an absent optional tensor is
    no key)."""
    out = {n: leaf(t) for n, t in m.named_parameters(recurse=False)}
    out.update({n: _module_tree(c, leaf) for n, c in m.named_children()})
    return out


def _stacked(trees: list[dict]) -> dict:
    """Nested dicts of equal structure, each leaf stacked on a new axis."""
    return {k: _stacked([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _groups(cfg: ModelConfig, model) -> dict:
    """The reference tree's top-level keys, each with what it holds: a
    module, a tensor, or a list (one stacked axis) of modules or of such
    lists."""
    out = {"tok": model.tok, "ln_f": model.ln_f}
    if cfg.family == "hybrid":
        out["attn_layers"] = [sb.attn_layer for sb in model.blocks]
        for name in ("mamba_moe", "mamba_dense"):
            out[name] = [list(getattr(sb, name)) for sb in model.blocks]
    elif cfg.family == "vlm":
        out["self_layers"] = [list(sb.self_layers) for sb in model.blocks]
        out["cross_layers"] = [sb.cross for sb in model.blocks]
    elif _alternating(cfg):
        out["dense_layers"] = [list(sb.dense_layers) for sb in model.blocks]
        out["moe_layers"] = [sb.moe_layer for sb in model.blocks]
    else:
        out["layers"] = list(model.layers)
        if cfg.family == "audio":
            out["head"] = model.head
    return out


def param_tree(cfg: ModelConfig, model, leaf=lambda t: t) -> dict:
    """The reference's parameter tree of ``model``: ``leaf(parameter)`` at
    every leaf, per-layer leaves stacked on the reference's layer axes
    (new tensors: ``torch.stack`` copies)."""
    def tree(x):
        if isinstance(x, list):
            return _stacked([tree(y) for y in x])
        if isinstance(x, nn.Module):
            return _module_tree(x, leaf)
        return leaf(x)
    return {k: tree(v) for k, v in _groups(cfg, model).items()}


# ---------------------------------------------------------------------------
# logical-axis specs: what every reference ``init`` returns beside params
# ---------------------------------------------------------------------------

def _pick(axes: dict, names) -> dict:
    return {n: axes[n] for n in names}


def _norm_specs(cfg: ModelConfig) -> dict:
    return _pick(L.NORM_AXES, ("scale", "bias") if cfg.norm == "layernorm"
                 else ("scale",))


def _attention_specs(cfg: ModelConfig) -> dict:
    names = ["wq", "wk", "wv", "wo"]
    if cfg.qkv_bias:
        names += ["bq", "bk", "bv"]
    if cfg.qk_norm:
        names += ["q_norm", "k_norm"]
    return _pick(L.ATTN_AXES, names)


def _mlp_specs(cfg: ModelConfig) -> dict:
    return _pick(L.MLP_AXES, ("w_gate", "w_up", "w_down") if cfg.act == "silu"
                 else ("w_in", "b_in", "w_out", "b_out"))


def _embedding_specs(cfg: ModelConfig) -> dict:
    return _pick(L.EMBED_AXES, ("embed",) if cfg.tie_embeddings
                 else ("embed", "lm_head"))



def _layer_specs(cfg: ModelConfig, mixer: str, ffn: str) -> dict:
    """One layer: ``ln1``, the mixer (``attn``, ``xattn`` or ``ssm``),
    ``ln2`` and the FFN (``mlp`` or ``moe``)."""
    return {"ln1": _norm_specs(cfg),
            mixer: dict(SSM_AXES) if mixer == "ssm"
            else _attention_specs(cfg),
            "ln2": _norm_specs(cfg),
            ffn: dict(moe.MOE_AXES) if ffn == "moe" else _mlp_specs(cfg)}


def _stacked_specs(tree: dict, axes: int) -> dict:
    """Every leaf behind ``axes`` unsharded layer axes."""
    return tree_map(lambda t: (None,) * axes + t, tree)


def param_specs(cfg: ModelConfig) -> dict:
    """The reference's logical-axis tree (``get_model(cfg).init(key)[1]``)
    on :func:`param_tree`'s layout: a tuple of logical axis names (or
    ``None``) at every leaf, one a tensor dim, stacked layer axes
    unsharded (``None``)."""
    out = {"tok": _embedding_specs(cfg)}
    if cfg.family == "hybrid":
        out["attn_layers"] = _stacked_specs(_layer_specs(cfg, "attn", "mlp"),
                                            1)
        out["mamba_moe"] = _stacked_specs(_layer_specs(cfg, "ssm", "moe"), 2)
        out["mamba_dense"] = _stacked_specs(_layer_specs(cfg, "ssm", "mlp"),
                                            2)
    elif cfg.family == "vlm":
        out["self_layers"] = _stacked_specs(_layer_specs(cfg, "attn", "mlp"),
                                            2)
        cross = _layer_specs(cfg, "xattn", "mlp")
        cross.update(gate_attn=(), gate_mlp=())
        out["cross_layers"] = _stacked_specs(cross, 1)
    elif _alternating(cfg):
        out["dense_layers"] = _stacked_specs(
            _layer_specs(cfg, "attn", "mlp"), 2)
        out["moe_layers"] = _stacked_specs(_layer_specs(cfg, "attn", "moe"),
                                           1)
    elif cfg.family == "ssm":
        out["layers"] = _stacked_specs({"ln": _norm_specs(cfg),
                                        "ssm": dict(SSM_AXES)}, 1)
    else:
        ffn = "moe" if cfg.family == "moe" else "mlp"
        out["layers"] = _stacked_specs(_layer_specs(cfg, "attn", ffn), 1)
        if cfg.family == "audio":
            out["head"] = L.EMBED_AXES["head"]
    out["ln_f"] = _norm_specs(cfg)
    return out


def local_tree(cfg: ModelConfig, tree: dict, specs: dict | None = None
               ) -> dict:
    """This rank's block of every leaf of ``tree`` (the reference's
    layout, global shapes; numpy arrays or tensors) under the active
    rules, by ``specs`` (default :func:`param_specs`), each a copy of its
    own: the same reference weights load onto any mesh.  Without rules,
    ``tree`` itself."""
    lay = tp.layout()
    if lay is None:
        return tree

    def block(names, t):
        b = tp.local_block(t, names, lay)
        return b.clone() if isinstance(b, torch.Tensor) else np.array(b)
    specs = param_specs(cfg) if specs is None else specs
    return tree_map(block, specs, tree)


@functools.lru_cache(maxsize=None)
def _shapes(cfg: ModelConfig) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from . import get_model
    with FakeTensorMode():
        model = get_model(cfg).init(torch.Generator(), "cpu")
        return tree_map(lambda t: tuple(t.shape), param_tree(cfg, model))


def param_shapes(cfg: ModelConfig) -> dict:
    """The global shape of every leaf of :func:`param_tree` (the model
    built on fake tensors, no memory; cached a configuration)."""
    return _shapes(cfg)


def bind_params(cfg: ModelConfig, model, tree: dict) -> None:
    """Point every parameter of ``model`` at its slice of ``tree`` (the
    reference's layout, the parameters' dtypes): afterwards the module's
    tensors are views of the tree's, so writing the tree's leaves in place
    updates the model, one copy a leaf for all its layers."""
    def bind(x, sub):
        if isinstance(x, list):
            for i, y in enumerate(x):
                bind(y, _take(sub, i))
        elif isinstance(x, nn.Module):
            for n, t in x.named_parameters(recurse=False):
                bind(t, sub[n])
            for n, c in x.named_children():
                bind(c, sub[n])
        else:
            if sub.shape != x.shape or sub.dtype != x.dtype:
                raise ValueError(f"cannot bind {tuple(sub.shape)} "
                                 f"{sub.dtype} to {tuple(x.shape)} {x.dtype}")
            x.data = sub
    for k, v in _groups(cfg, model).items():
        bind(v, tree[k])


def params_to_numpy(cfg: ModelConfig,
                    model: Transformer | moe.AlternatingMoE | jamba.Jamba
                    | vlm.VLM) -> dict:
    """The reference's parameter tree of ``model``, numpy leaves in
    ``cfg.param_dtype``.  Weights the port keeps in a narrower compute
    dtype widen exactly, so ``params_from_numpy`` of the result rebuilds
    the same tensors."""
    dt = torch_dtype(cfg.param_dtype)
    return tree_map(lambda t: t.to(dt).cpu().numpy(),
                param_tree(cfg, model, lambda t: t.detach()))


# ---------------------------------------------------------------------------
# training state: {"params", "opt": {"m", "v", "step"}, "ef"?}
# ---------------------------------------------------------------------------

def train_state_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's training state (``train_state_init`` /
    ``make_train_step``'s tree, leaves as numpy arrays or tensors) as the
    port's: the same tree, every leaf a tensor on ``device`` (the card
    unless the caller passes one) of its own dtype (``step`` int32, the
    rest float32), bit for bit, in memory of its own."""
    device = resolve_device(device)

    def leaf(a):
        dtype, arr = host_leaf(a)
        return device_leaf(dtype, np.array(arr), device)
    return tree_map(leaf, tree)


def train_state_to_numpy(state: dict) -> dict:
    """The port's training state as the JAX package's tree of numpy
    arrays, bit for bit: its inverse."""
    return tree_map(lambda t: host_leaf(t)[1], state)
