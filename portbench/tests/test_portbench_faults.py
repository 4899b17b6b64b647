"""A whole run of each cell's driver on the CPU at a tiny size (the look
for a card skipped), with the cell's own limits: sound, it comes out
correct; with the timed path broken underneath, not.  The faults a cell
can have: a token altered where it is produced (serving); a step that
returns its state unchanged (from the start, or only in the window, which
the comparison of the window's steps catches), and half of the batch left
out with the mean taken over the rest (training).  One card, so no exchange between chips to
leave out.  And the control at this size: the FP8 reference in the
program's place reads a wider gap than the program."""

import pytest
import torch

from portbench.lib import cell
from portbench.tests import tiny


def _argmin_decode(monkeypatch, family):
    """Every decode step's token the least likely one: the token altered
    where the program produces it (the family's one decode step, which
    the fused decode calls)."""
    import repro_torch.models as models
    mod = models._FAMILY[family]
    step = mod.decode

    def bad(cfg, p, token, pos, cache):
        logits, cache = step(cfg, p, token, pos, cache)
        return -logits, cache
    monkeypatch.setattr(mod, "decode", bad)


def _serving(name, **kw):
    return tiny.open_context(**kw) if name == "open-loop" else \
        tiny.context(name, **kw)


@pytest.mark.parametrize("name", ["open-loop", "granite-batch"])
def test_serving_cell_sound_then_a_token_altered(name, monkeypatch):
    ctx = _serving(name)
    res = cell.driver(ctx.traffic["kind"]).run(ctx)
    assert res.correct, res.checks
    assert res.layer["notes"]["readings"]["tokens"] >= 8
    _argmin_decode(monkeypatch, ctx.dims.family)
    ctx = _serving(name)
    res = cell.driver(ctx.traffic["kind"]).run(ctx)
    assert not res.correct, res.checks


def test_serving_control_reads_wider_than_the_program():
    """The FP8 reference in the program's place reads ten times wider, and
    through the tiny open loop's limits comes out not correct.  (The
    cells' own limits are set at their size on the card, where
    ``calibrate.py`` holds the control to them; at this size its rounding
    through two layers stays under them.)"""
    ctx = tiny.open_context(seed=21)
    res = cell.driver(ctx.traffic["kind"]).run(ctx)
    prog = cell.compare_served(ctx, res.layer["compare"])
    ctl = cell.compare_served(ctx, res.layer["compare"], control=True)
    assert prog["tokens"] == ctl["tokens"] >= 8
    for number in ("logit_gap", "logit_gap_mean"):
        assert ctl[number] > 10 * max(prog[number], 1e-6), number
    assert cell.passes(cell.checks(dict(prog, unserved=0), ctx.limits))
    assert not cell.passes(cell.checks(dict(ctl, unserved=0), ctx.limits))


def _train(monkeypatch=None, fault=None):
    import repro_torch.train.step as step_mod
    if fault == "unchanged":
        def frozen(self, state, batch):
            loss, _ = self._loss_and_grads(state["params"], batch)
            return {"loss": loss, "grad_norm": loss * 0, "lr": loss * 0}
        monkeypatch.setattr(step_mod.TrainStep, "update_", frozen)
    elif fault == "unchanged_in_window":
        real, calls = step_mod.TrainStep.update_, {"n": 0}

        def late(self, state, batch):
            calls["n"] += 1
            if calls["n"] <= 3:           # set-up's steps run sound
                return real(self, state, batch)
            loss, _ = self._loss_and_grads(state["params"], batch)
            return {"loss": loss, "grad_norm": loss * 0, "lr": loss * 0}
        monkeypatch.setattr(step_mod.TrainStep, "update_", late)
    elif fault == "half_batch":
        whole = step_mod._loss_fn

        def half(model, cfg, params, batch):
            h = batch["tokens"].shape[0] // 2
            return whole(model, cfg, params,
                         {k: v[:h] for k, v in batch.items()})
        monkeypatch.setattr(step_mod, "_loss_fn", half)
    return cell.driver("train").run(tiny.train_context())


def test_training_cell_sound():
    res = _train()
    assert res.correct, res.checks
    assert res.metrics["train_tok_s"] > 0 and res.attempted >= 1


def test_training_control_reads_wider_than_the_program():
    """The reference in float8 in the program's place, on the same tokens
    and from the same state copied before the window's compared steps,
    reads every number compared ten times wider than the program; in
    bfloat16 (the witness of the program's own rounding) it passes the
    cell's limits."""
    from portbench.drivers import train
    from portbench.reference import dense
    ctx = tiny.train_context()
    got = train.program(ctx)
    prog, fp8, bf16 = train.all_readings(ctx, got,
                                         [None, dense.FP8, dense.BF16])
    assert cell.passes(cell.checks(prog, ctx.limits)), prog
    assert cell.passes(cell.checks(bf16, ctx.limits)), bf16
    for number in ctx.limits:
        if number != "window_steps":
            assert fp8[number] > 10 * max(prog[number], 1e-6), number


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "unchanged_in_window"])
def test_training_cell_fault(fault, monkeypatch):
    res = _train(monkeypatch, fault)
    assert not res.correct, res.checks


def test_a_run_without_a_card_prints_no_result(monkeypatch, capsys):
    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "qwen2-train", "--seed", "1", "--seconds",
                  "1", "--trace", "0"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
