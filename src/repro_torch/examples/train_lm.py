"""End-to-end training example: train a small LM with
checkpointing, then kill-and-resume to demonstrate the fault-tolerance
contract (restart-deterministic).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
        [--device cpu]

The port's counterpart of ``examples/train_lm.py``: the same reduced
config, batch, microbatches and checkpoint cadence, through
:func:`repro_torch.launch.train.run`, with the config's heads widened to
64 through the launcher's ``--d-model`` (``serve_lm.example_config``).  The checkpoints go to a temporary
directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.device import resolve_device
from repro_torch.examples.serve_lm import example_config
from repro_torch.launch.train import run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    common = ["--arch", args.arch, "--reduced", "--global-batch", "16",
              "--seq-len", "64", "--microbatches", "2", "--device", str(dev),
              "--d-model", str(example_config(args.arch).d_model)]
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ck_")
    try:
        print(f"=== phase 1: train to step {args.steps//2}, checkpointing ===")
        first = run(common + ["--steps", str(args.steps // 2), "--ckpt-dir",
                              ckpt, "--ckpt-every", "25"])
        print("\n=== phase 2: 'node failure' -> resume from checkpoint ===")
        out = run(common + ["--steps", str(args.steps), "--ckpt-dir", ckpt,
                            "--ckpt-every", "50", "--resume"])
        print(f"\nfinal loss after resume: {out['final_loss']:.4f}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return {"first": first, "resumed": out}


if __name__ == "__main__":
    main()
