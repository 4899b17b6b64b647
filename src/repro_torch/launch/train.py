"""Training launcher: the port's counterpart of ``repro/launch/train.py``,
an end-to-end driver with checkpoint / restart and deterministic,
resumable data.  It runs on the card unless ``--device cpu`` is given.

Examples::

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 20 \\
        --global-batch 8 --seq-len 1024
    python -m repro_torch.launch.train --device cpu --arch smollm-135m \\
        --reduced --steps 200 --ckpt-dir /tmp/ck --resume

The reference's flags, plus ``--device``.  Parameters are drawn from a
``torch.Generator`` seeded with ``--seed`` on the device; audio frames and
vlm image embeddings, which the synthetic data does not hold, from a
generator seeded with the step number, as the reference draws them from
``PRNGKey(step)`` (other numbers: JAX's and torch's generators differ).
Checkpoints go through the port's :class:`AsyncCheckpointer` in the JAX
package's file format, so either package resumes the other's run.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from ..checkpoint import AsyncCheckpointer, latest_step, load_checkpoint
from ..configs import ARCH_IDS, get_config
from ..data import DataConfig, SyntheticLMData
from ..device import resolve_device
from ..models import get_model
from ..optim.adamw import AdamWConfig
from ..distributed.sharding import use_rules
from ..train.step import (DonatedStep, local_train_state, make_train_step,
                          train_state_init, whole_train_state)


def _normal(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def run(argv=None, mesh=None) -> dict:
    """Parse ``argv``, train, and return ``{"final_loss", "losses",
    "step_s" (each step's wall seconds, the loss read back), "state",
    "step" (the :class:`~repro_torch.train.step.DonatedStep`)}``.  The
    steps run through the donated step's cell, the state updated in
    place (the reference's ``jax.jit(..., donate_argnums=0)``): on the
    card the first step is the cell's build, the step run eagerly and
    then captured, so ``step_s[0]`` holds the capture too, and every later
    step replays the graph; with ``--device cpu`` every step runs eagerly
    over the cell's buffers.  A resumed or re-meshed state is new
    tensors, so its first step builds a new cell.  With
    ``mesh`` (a ``DeviceMesh`` over a process group the caller started,
    every rank calling ``run``), the steps run under its rules: the
    state is each rank's block (``train.step.local_train_state``), the
    layers sharded (``distributed.tp``).  A checkpoint from a mesh holds
    the whole state, gathered (``train.step.whole_train_state``) and
    written by rank 0 while the others wait, in the same files as one
    without: a run resumes it onto any mesh, or none, by loading it whole
    and taking its rank's block.  ``"state"`` is the rank's block."""
    with use_rules(mesh) if mesh is not None else contextlib.nullcontext():
        return _run(argv, mesh)


def _run(argv, mesh) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-dcn", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    over = {}
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_model:
        over["d_model"] = args.d_model
    if over:
        cfg = dataclasses.replace(cfg, **over)
    model = get_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                          total_steps=args.steps)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = train_state_init(model, gen, opt_cfg,
                             compress_dcn=args.compress_dcn, device=device)
    step_fn = DonatedStep(make_train_step(model, opt_cfg,
                                          microbatches=args.microbatches,
                                          compress_dcn=args.compress_dcn))

    start_step = 0
    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state, extra = load_checkpoint(args.ckpt_dir, last, state,
                                           device=device)
            start_step = extra["data"]["step"]
            print(f"resumed from step {last} (data step {start_step})")
    if mesh is not None:
        state = local_train_state(model, state)

    data = SyntheticLMData(DataConfig(
        vocab=cfg.vocab, global_batch=args.global_batch,
        seq_len=args.seq_len, seed=args.seed), start_step=start_step)

    losses, step_s = [], []
    t0 = time.perf_counter()        # duration base, not a timestamp
    for i in range(start_step, args.steps):
        ts = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(i).items()}
        if cfg.family == "audio":
            batch = {"frames": _normal((args.global_batch, args.seq_len,
                                        cfg.d_model), i, device),
                     "labels": batch["labels"] % cfg.vocab}
        if cfg.family == "vlm":
            batch["image_embeds"] = _normal(
                (args.global_batch, cfg.n_image_tokens, cfg.d_model), i,
                device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])       # waits for the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if i % args.log_every == 0 or i == args.steps - 1:
            tps = args.global_batch * args.seq_len / max(
                1e-9, (time.perf_counter() - t0) / max(1, len(losses)))
            print(f"step {i:5d} loss {loss:.4f} "
                  f"grad_norm {float(metrics['grad_norm']):.3f} "
                  f"tok/s {tps:,.0f}", flush=True)
        if ckpt and (i + 1) % args.ckpt_every == 0:
            _save(ckpt, i + 1, model, state, mesh)
    if ckpt:
        _save(ckpt, args.steps, model, state, mesh)
        ckpt.wait()
        if mesh is not None:
            dist.barrier()          # rank 0's files are on disk
    data.close()
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "step_s": step_s, "state": state, "step": step_fn}


def _save(ckpt: AsyncCheckpointer, step: int, model, state, mesh) -> None:
    """``state`` into ``ckpt`` at ``step``; from a mesh the whole state,
    every rank gathering, rank 0 writing (its snapshot taken before the
    others go on).  ``save`` copies every leaf to host memory before it
    returns, so the steps after it, which update ``state`` in place, do
    not reach the files."""
    extra = {"data": {"step": step}}
    if mesh is None:
        ckpt.save(step, state, extra=extra)
        return
    whole = whole_train_state(model, state)
    if dist.get_rank() == 0:
        ckpt.save(step, whole, extra=extra)
    dist.barrier()


if __name__ == "__main__":
    run()
