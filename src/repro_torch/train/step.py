"""Training step: the port's counterpart of ``repro/train/step.py``.

* next-token LM loss (frame classification for the audio family),
* microbatch gradient accumulation in float32,
* optional error-feedback int8 compression of the gradients
  (``compress_dcn``),
* AdamW (:mod:`repro_torch.optim.adamw`).

The training state is the reference's tree with torch leaves:
``{"params", "opt": {"m", "v", "step"}, "ef"?}``, ``params`` in the
reference's layout (per-layer leaves stacked) and ``param_dtype``
(float32): the master weights.  :func:`repro_torch.models.convert.
train_state_from_numpy` carries a JAX state in, and the port's
checkpointer writes it as the JAX package's files.

The model computes in ``compute_dtype``, as the reference's
``p.astype(cdt)`` at each use: :class:`TrainStep` keeps one compute copy
of the parameters (the family's ``nn.Module``, its tensors views of one
stacked tree, see ``convert.bind_params``), writes the masters into it at
every step (one cast a leaf), runs ``Model.forward`` and the loss with
autograd, and stacks the parameters' gradients back into the reference's
tree in float32: the gradient of the float32 master is the cast of the
compute copy's, as the reference's autodiff through ``astype`` gives.
Randomness for parameter init comes from an explicit ``torch.Generator``
(or from a JAX state carried across), never from torch's global RNG.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..configs.base import ModelConfig, torch_dtype
from ..distributed import tp
from ..models import Model
from ..models import convert
from ..models import layers as L
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compression import ef_compress_grads, ef_init
from ..tree import tree_leaves, tree_map
from .losses import cross_entropy

TrainState = dict          # {"params", "opt": {"m", "v", "step"}, "ef"?}


def train_state_init(model: Model, generator: torch.Generator,
                     opt_cfg: AdamWConfig, compress_dcn: bool = False,
                     device=None) -> TrainState:
    """A fresh state: ``model.init`` drawn from ``generator`` on ``device``
    (the card unless the caller passes one; the generator must live
    there), the masters in ``param_dtype``, AdamW's zeros and, with
    ``compress_dcn``, the zero error-feedback residual.  Unlike the
    reference it returns no sharding specs: :func:`train_state_specs`
    gives them."""
    cfg = model.cfg
    dt = torch_dtype(cfg.param_dtype)
    params = convert.param_tree(cfg, model.init(generator, device),
                                lambda t: t.detach().to(dt, copy=True))
    state = {"params": params, "opt": adamw_init(params)}
    if compress_dcn:
        state["ef"] = ef_init(params)
    return state


def train_state_specs(model: Model, compress_dcn: bool = False) -> dict:
    """The logical-axis tree of :func:`train_state_init`'s state, the
    reference's ``state_specs``: AdamW's moments (and the error-feedback
    residual) as the parameters, the step count a scalar."""
    specs = convert.param_specs(model.cfg)
    out = {"params": specs, "opt": {"m": specs, "v": specs, "step": ()}}
    if compress_dcn:
        out["ef"] = specs
    return out


def local_train_state(model: Model, state: TrainState) -> TrainState:
    """This rank's block of a (global) training state under the active
    rules, by :func:`train_state_specs`: the masters and AdamW's moments
    are sharded as the parameters, the step count whole."""
    specs = train_state_specs(model, "ef" in state)
    return convert.local_tree(model.cfg, state, specs)


def whole_train_state(model: Model, state: TrainState) -> TrainState:
    """The global training state from the rank's blocks under the active
    rules (every rank of the mesh calls it): each leaf gathered over the
    mesh axes its :func:`train_state_specs` entry shards it on.  Without
    rules, ``state`` itself."""
    if tp.layout() is None:
        return state
    shapes = convert.param_shapes(model.cfg)
    tree = {"params": shapes, "opt": {"m": shapes, "v": shapes, "step": ()}}
    if "ef" in state:
        tree["ef"] = shapes
    return tree_map(lambda names, shape, t: tp.full(t, names, shape),
                    train_state_specs(model, "ef" in state), tree, state)


def _loss_fn(model: Model, cfg: ModelConfig, params, batch):
    """The mean loss over the batch; under rules over the rank's rows (the
    logits ``forward`` gives)."""
    labels = batch["labels"]
    if tp.layout() is not None:   # ``forward`` gives the rank's tokens
        labels = tp.token_block(labels)
    if cfg.family == "audio":
        logits = model.forward(params, {"frames": batch["frames"]})
        return cross_entropy(logits, labels)
    fwd_batch = {"tokens": batch["tokens"]}
    if cfg.family == "vlm":
        fwd_batch["image_embeds"] = batch["image_embeds"]
    logits = model.forward(params, fwd_batch)
    # next-token prediction: logits[t] predicts labels[t]
    return cross_entropy(logits, labels)


def _synced_grads(cfg: ModelConfig, grads, lay):
    """Each gradient summed over the mesh axes its parameter is replicated
    on."""
    specs, shapes = convert.param_specs(cfg), convert.param_shapes(cfg)

    def sync(names, shape, g):
        axes = tp.replicated_axes(names, shape, lay)
        return tp.reduce(g, axes) if axes else g
    return tree_map(sync, specs, shapes, grads)


def _global_norm(cfg: ModelConfig, grads, lay) -> torch.Tensor:
    """The global norm of the rank's gradient blocks: every rank's squared
    sums, a leaf's divided by its number of replicas, summed over the
    mesh."""
    specs, shapes = convert.param_specs(cfg), convert.param_shapes(cfg)
    sq = tree_map(lambda names, shape, g: g.float().square().sum()
                  / _replicas(names, shape, lay), specs, shapes, grads)
    return torch.sqrt(tp.reduce(sum(tree_leaves(sq)), tuple(lay.sizes)))


def _replicas(names, shape, lay) -> int:
    return math.prod(lay.size(a)
                     for a in tp.replicated_axes(names, shape, lay))


def _leaf_absmax(cfg: ModelConfig, lay):
    """Each leaf's ``max|x|`` over the whole leaf from the rank's block:
    the block's max all-reduced over the mesh axes the leaf is sharded on
    (compression's :func:`~repro_torch.optim.compression.quantize`)."""
    def one(names, shape):
        axes = tuple(a for ax in lay.spec(names, shape) for a in ax)
        return lambda x: tp.reduce_max(x.abs().max(), axes)
    return tree_map(one, convert.param_specs(cfg), convert.param_shapes(cfg))


def _microbatches(batch: dict, mb: int):
    """The batch's ``mb`` parts along its rows.  Under rules each rank
    splits its own rows: part ``i`` holds every rank's ``i``-th part of
    its rows, so a rank's rows of part ``i`` (``tp.batch_block``) are rows
    it holds.  Without rules, part ``i`` is rows ``i * B / mb ..``, the
    reference's."""
    rows = next(v.shape[0] for v in batch.values() if v.dim() >= 1)
    lay = tp.layout()
    n = 1 if lay is None else lay.count(tp.batch_axes(rows // mb, lay))
    for i in range(mb):
        yield {k: v.reshape(n, mb, -1, *v.shape[1:])[:, i].reshape(
            -1, *v.shape[1:]) if v.dim() >= 1 else v
            for k, v in batch.items()}


class _Compute:
    """The compute copy of a model's parameters: the family's module with
    gradients on, its tensors views of one tree in the reference's layout,
    built at first use on the masters' device."""

    def __init__(self, model: Model):
        self.model = model
        self.module = None
        self._tree = None

    def load(self, params) -> torch.nn.Module:
        """Write the masters ``params`` into the compute copy; return the
        module."""
        cfg = self.model.cfg
        if self.module is None:
            dev = tree_leaves(params)[0].device
            self.module = L.set_trainable(
                convert.params_from_numpy(cfg, params, device=dev))
            # copies: the module built from ``params`` may alias them
            self._tree = convert.param_tree(cfg, self.module,
                                            lambda t: t.detach().clone())
            convert.bind_params(cfg, self.module, self._tree)
        with torch.no_grad():
            for c, m in zip(tree_leaves(self._tree), tree_leaves(params)):
                c.copy_(m)
        return self.module


class TrainStep:
    """``step(state, batch) -> (new state, metrics)``, what the reference's
    ``make_train_step`` returns (the launcher jits it there; here each call
    runs eagerly).  ``batch``: ``tokens`` and ``labels`` (B, S) on the
    parameters' device, ``frames`` (B, S, D) in place of ``tokens`` for the
    audio family, ``image_embeds`` (B, n_img, D) besides for the vlm.
    :attr:`module` is the compute copy; its parameters keep the last
    backward's gradients until the next step."""

    def __init__(self, model: Model, opt_cfg: AdamWConfig,
                 microbatches: int = 1, compress_dcn: bool = False):
        self.model = model
        self.opt_cfg = opt_cfg
        self.microbatches = microbatches
        self.compress_dcn = compress_dcn
        self._compute = _Compute(model)

    @property
    def module(self):
        return self._compute.module

    def value_and_grad(self, params, batch):
        """(loss, gradients): the loss a float32 0-d tensor, the gradients
        the reference's tree in float32 (zeros for a parameter the loss
        does not reach, as the reference's autodiff gives).  Under rules
        the loss is the mesh's and the gradients the rank's blocks, each
        summed over the ranks it is replicated on."""
        cfg = self.model.cfg
        module = self._compute.load(params)
        for p in module.parameters():
            p.grad = None
        lay = tp.layout()
        with torch.enable_grad():
            loss = _loss_fn(self.model, cfg, module, batch)
            if lay is not None:
                # the collectives' backward sums over ranks: each rank's
                # share of the mesh's mean
                loss = loss / lay.world
            loss.backward()
        grads = convert.param_tree(
            cfg, module, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
            if p.grad is None else p.grad.float())
        if lay is not None:
            grads = _synced_grads(cfg, grads, lay)
            loss = tp.reduce(loss.detach(), tuple(lay.sizes))
        return loss.detach(), grads

    def __call__(self, state: TrainState, batch):
        params = state["params"]
        mb = self.microbatches
        if mb <= 1:
            loss, grads = self.value_and_grad(params, batch)
        else:
            # the batch's rows in microbatches; gradients summed in f32
            gsum = loss_sum = None
            for part in _microbatches(batch, mb):
                loss, g = self.value_and_grad(params, part)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                loss_sum = loss if loss_sum is None else loss_sum + loss
            grads = tree_map(lambda g: g / mb, gsum)
            loss = loss_sum / mb
        new_state = dict(state)
        lay = tp.layout()
        cfg = self.model.cfg
        if self.compress_dcn:
            grads, new_state["ef"] = ef_compress_grads(
                grads, state["ef"],
                None if lay is None else _leaf_absmax(cfg, lay))
        new_params, new_opt, metrics = adamw_update(
            self.opt_cfg, grads, state["opt"], params,
            grad_norm=None if lay is None else _global_norm(cfg, grads, lay))
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        return new_state, dict(metrics, loss=loss)


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatches: int = 1,
                    compress_dcn: bool = False) -> TrainStep:
    return TrainStep(model, opt_cfg, microbatches, compress_dcn)


def make_eval_step(model: Model) -> Callable:
    """``eval_step(params, batch) -> loss`` on the masters ``params``,
    without a graph."""
    compute = _Compute(model)

    def eval_step(params, batch):
        module = compute.load(params)
        with torch.no_grad():
            return _loss_fn(model, model.cfg, module, batch)

    return eval_step
