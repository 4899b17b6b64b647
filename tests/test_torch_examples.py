"""The port's examples (``repro_torch.examples``) on the CPU:

* the three paper examples print what the JAX package's
  ``examples/quickstart.py``, ``interference_adaptation.py`` and
  ``vgg16_classify.py`` print, line for line and digit for digit (the
  representative-layer line names the port's kernel instead of the Pallas
  one and gives the same verdict);
* the VGG-16 real forward's activations, layer by layer, are within 1e-5
  relative of a numpy forward on the reference's draws (the reference
  example's math: ``np.maximum(a @ w, 0)``), every TAO ran at a valid place
  and the PTT learned one sample a TAO;
* the serving and training examples run on the CPU, on the same widened
  configs as on the card, and keep the port's own invariants: every request finishes with in-vocabulary tokens, the
  PTTs learn, the region drain ships, the SLO alert fires at pump 3 and
  clears, and the resumed training run's losses equal phase 1's state
  carried on in memory under phase 2's settings, bit for bit.

Their weights come from the port's seed, so their streams are not the JAX
examples' streams; serving parity is held by the other port tests.
"""

import contextlib
import importlib.util
import io
import os
import re

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is as fast, and the suite's other
    workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


@pytest.mark.parametrize("name", ["quickstart", "interference_adaptation"])
def test_sim_example_prints_the_reference(name):
    from repro_torch.examples import interference_adaptation, quickstart
    port = {"quickstart": quickstart,
            "interference_adaptation": interference_adaptation}[name]
    ref_text, _ = _printed(_reference_example(name).main)
    text, out = _printed(port.main)
    assert text == ref_text
    if name == "quickstart":
        assert "speedup=3.60x" in text and "speedup=1.10x" in text
        assert out["mixed random DAG (par~4)"] > 1.0
    else:
        assert "makespan with interference: 291.7" in text
        assert "makespan without:           280.3" in text
        assert out["makespan"] > out["clean_makespan"]


def test_vgg16_example_prints_the_reference():
    from repro_torch.examples import vgg16_classify
    ref = _reference_example("vgg16_classify")
    ref_text, _ = _printed(lambda: (ref.scaling_study(), ref.real_forward()))
    text, _ = _printed(vgg16_classify.main, ["--device", "cpu"])
    ref_lines, lines = ref_text.splitlines(), text.splitlines()
    assert lines[:-1] == ref_lines[:-1]
    assert ref_lines[-1].endswith("matches jnp oracle: True")
    assert lines[-1] == "  matmul kernel (cpu) matches matmul_ref: True"
    times = [float(t) for t in re.findall(r"time=\s*([0-9.]+)", text)]
    assert len(times) == 6 and all(a > b for a, b in zip(times, times[1:]))


def test_vgg16_real_forward_matches_numpy():
    from repro_torch.core import Place
    from repro_torch.examples import vgg16_classify as V
    with contextlib.redirect_stdout(io.StringIO()):
        out = V.real_forward("cpu")
    # the reference example's draws, in its order, and its math
    rng = np.random.default_rng(0)
    a = rng.standard_normal((V.PATCHES, V.LAYERS[0][0])).astype(np.float32)
    want = [a]
    for _, C in V.LAYERS:
        w = rng.standard_normal((want[-1].shape[1], C)).astype(np.float32)
        want.append(np.maximum(want[-1] @ w, 0.0))
    assert len(out["acts"]) == len(want) == 5
    for got, ref in zip(out["acts"], want):
        got = got.numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    n_taos = V.TAOS_PER_LAYER * len(V.LAYERS)
    assert sorted(out["placements"]) == list(range(n_taos))
    layout = out["ptt"].cfg.layout
    assert all(layout.is_valid(Place(l, w))
               for l, w in out["placements"].values())
    assert out["ptt"].updates == n_taos
    # one recorded matmul a body chunk: as many as the widths chosen
    assert len(out["chunks"]) == sum(w for _, w in
                                      out["placements"].values())
    assert out["representative_ok"]


def _finished(reqs, vocab, n_new):
    for r in reqs:
        assert r.done and len(r.out_tokens) == n_new
        assert all(0 <= t < vocab for t in r.out_tokens)


def test_serve_lm_example_runs_on_cpu():
    from repro_torch.examples import serve_lm
    with contextlib.redirect_stdout(io.StringIO()):
        out = serve_lm.main(["--device", "cpu"])
    _finished(out["requests"], out["vocab"], 8)
    eng = out["engine"]
    # one sample a whole-prompt prefill and one a decode step
    assert eng.scheduler.ptt.updates > len(out["requests"])
    assert eng.stats()["requests_served"] == 8


def test_fleet_serve_example_runs_on_cpu():
    from repro_torch.examples import fleet_serve
    with contextlib.redirect_stdout(io.StringIO()):
        out = fleet_serve.main(["--device", "cpu"])
    _finished(out["requests"], out["vocab"], 6)
    gw = out["gateway"]
    st = gw.stats()
    assert st["served"] == 8 and sum(st["per_replica"]) == 8
    assert gw.router.fleet.updates > 0
    assert sorted(gw.ttfts()) == list(range(8))


def test_region_serve_example_runs_on_cpu():
    from repro_torch.examples import region_serve
    with contextlib.redirect_stdout(io.StringIO()):
        out = region_serve.main(["--device", "cpu"])
    _finished(out["requests"].values(), out["vocab"], 10)
    st = out["stats"]
    assert st["wan_ships"] >= 1 and st["wan_bytes"] > 0
    assert sum(st["fleet_served"]) == 4 and st["browned_out"] == [0]


def test_slo_smoke_example_runs_on_cpu(tmp_path):
    from repro_torch.examples import slo_smoke
    with contextlib.redirect_stdout(io.StringIO()):
        out = slo_smoke.main(["--device", "cpu", "--out-dir",
                              str(tmp_path)])
    # the crashed replica's requests are served as re-prefilled clones
    st = out["gateway"].stats()
    assert st["requests_served"] == 4 and st["crash_requests_resubmitted"]
    assert sorted(out["gateway"].ttfts()) == list(range(4))
    assert ("ttft_pumps", "firing", 3) in out["alerts"]
    assert any(s == "cleared" for _, s, _ in out["alerts"])
    for name in ("slo_timeseries.json", "slo_alerts.json"):
        assert (tmp_path / name).stat().st_size > 0


def test_train_lm_example_resumes_as_if_uninterrupted():
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.examples import train_lm
    from repro_torch.examples.serve_lm import example_config
    from repro_torch.models import get_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step
    steps, half = 8, 4
    with contextlib.redirect_stdout(io.StringIO()):
        out = train_lm.main(["--device", "cpu", "--steps", str(steps)])
    first, resumed = out["first"], out["resumed"]
    assert len(first["losses"]) == half
    assert len(resumed["losses"]) == steps - half
    assert all(np.isfinite(first["losses"] + resumed["losses"]))
    # phase 1's state carried on in memory under phase 2's settings (the
    # launcher's defaults and the example's flags)
    cfg = example_config("smollm-135m")
    step_fn = make_train_step(get_model(cfg), AdamWConfig(
        lr=3e-3, warmup_steps=max(5, steps // 20), total_steps=steps),
        microbatches=2)
    data = SyntheticLMData(DataConfig(vocab=cfg.vocab, global_batch=16,
                                      seq_len=64, seed=0), start_step=half)
    state, losses = first["state"], []
    for i in range(half, steps):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    data.close()
    assert losses == resumed["losses"]
