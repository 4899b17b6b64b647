"""The port's cost model and dry run: ``repro_torch.distributed.cost``
(the counterpart of ``hlo_cost.py`` / ``hlo_analysis.py``),
``distributed/roofline.py``, ``launch/dryrun.py`` and
``RooflineLatencyModel``, held against the reference where it has a
counterpart: ``tests/test_hlo_cost.py``, ``tests/test_dryrun.py`` and
``tests/test_elastic.py::test_latency_model_shape``.

* FLOPs scale with depth (a loop of 8 layers against 1, ratio in [7, 9]);
* collectives counted with the operand bytes of a contracting-dim
  reduction on a (2, 4) fake mesh, and a full-mesh reduction over (pod 2,
  data 2, model 2) classified cross-pod;
* the skip rules and the 31 runnable + 9 skipped cells;
* a (2, 2) tiny-mesh train cell with FLOPs, bytes and peak memory;
* ``model_flops`` and ``analytic_decode_bytes`` equal to the reference's
  for every architecture and shape;
* the counter's FLOPs on reduced qwen2 with heads widened to 64 (d_model
  896), prefill of 4 x 32 tokens on one device at 2 and 4 layers, within
  5 % of the reference's HLO walker (compiled in a subprocess);
* qwen2-0.5b x train_4k x single through ``python -m
  repro_torch.launch.dryrun`` in a subprocess (the fake 256-rank group):
  ``ok``, peak under 80 GiB a device, read back by
  ``RooflineLatencyModel.from_artifact``.

Fake process groups are global state, so each multi-rank case runs in a
subprocess of its own.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import run_subprocess
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.distributed import roofline as jroofline
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 shape_skip_reason, widen_heads)
from repro_torch.distributed import RooflineLatencyModel, roofline
from repro_torch.distributed.cost import CostCounter
from repro_torch.models import get_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _port(code: str) -> str:
    """``code`` in a fresh interpreter with the port on the path (no JAX
    is imported); its stdout."""
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {SRC!r})\n"
         + textwrap.dedent(code)], capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_scan_flops_scale_with_length():
    def f(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x.sum()

    fl = {}
    for L in (1, 8):
        ws = [torch.randn(128, 128) for _ in range(L)]
        with CostCounter() as c:
            f(ws, torch.randn(8, 128))
        fl[L] = c.totals.flops
    manual = 2 * 8 * 128 * 128
    assert abs(fl[1] - manual) / manual < 0.2, fl
    assert 7.0 <= fl[8] / fl[1] <= 9.0, fl


def test_collectives_counted():
    out = _port("""
    import torch, torch.distributed as dist
    from repro_torch.distributed import tp
    from repro_torch.distributed.cost import CostCounter
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    # x (16, 128) on P("data", "model"), w (128, 256) on P("model", None):
    # the contracting dim's partial products all-reduced over model
    x, w = torch.randn(8, 32), torch.randn(32, 256)
    with use_rules(mesh), CostCounter() as c:
        tp.reduce(x @ w, "model").sum()
    t = c.totals
    print(t.coll_counts["all-reduce"], t.wire_ici, t.coll_operand)
    """).split()
    n, wire, operand = int(out[0]), float(out[1]), float(out[2])
    assert n >= 1 and wire > 0
    assert operand >= 8 * 256 * 4
    assert wire == pytest.approx(2 * operand * 3 / 4)


def test_cross_pod_classification():
    out = _port("""
    import torch, torch.distributed as dist
    from repro_torch.distributed.cost import CostCounter
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import devices_per_pod, make_mesh
    fake_world(8)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    x = torch.randn(4, 8)
    with CostCounter(devices_per_pod(mesh)) as c:
        dist.all_reduce(x)                      # the full mesh
        dist.all_reduce(x, group=mesh.get_group("model"))
    t = c.totals
    print(t.wire_dcn, t.wire_ici, [o.cross_pod for o in c.ops])
    """)
    dcn, ici = (float(v) for v in out.split()[:2])
    assert dcn > 0 and ici > 0
    assert "[True, False]" in out


def test_skip_rules():
    assert shape_skip_reason(get_config("qwen2-0.5b"), "long_500k")
    assert shape_skip_reason(get_config("hubert-xlarge"), "decode_32k")
    assert shape_skip_reason(get_config("mamba2-130m"), "long_500k") is None
    assert shape_skip_reason(get_config("jamba-v0.1-52b"),
                             "long_500k") is None
    assert shape_skip_reason(get_config("qwen2-0.5b"), "train_4k") is None


def test_all_cells_enumerated():
    """31 runnable + 9 skipped = 40 assigned cells, as the reference's."""
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)
    skipped = sum(bool(shape_skip_reason(get_config(a), s))
                  for a in ARCH_IDS for s in SHAPES)
    assert len(ARCH_IDS) * len(SHAPES) == 40 and skipped == 9


def test_input_specs_match_reference():
    from repro.configs import input_specs as jinput_specs
    for a in ARCH_IDS:
        for s in SHAPES:
            got = input_specs(get_config(a), s)
            want = jinput_specs(jget_config(a), s)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape)
                assert str(t.dtype).split(".")[1] == str(want[k].dtype)


def test_tiny_mesh_train_cell():
    """Reduced qwen2 at 2 layers on a fake (2, 2) mesh, 4 x 32 tokens: the
    train step has FLOPs, bytes and a peak, and its collectives and the
    prefill's are pinned (``CHANGES.md`` sets them beside the reference
    walker's on the same cell)."""
    out = _port("""
    import dataclasses, json, torch
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import fake_world, trace
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(get_config("qwen2-0.5b", reduced=True),
                              n_layers=2)
    fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    meta = torch.empty((4, 32), dtype=torch.int32, device="meta")
    c, _ = trace(cfg, "train", {"tokens": meta, "labels": meta}, mesh)
    p, _ = trace(cfg, "prefill", {"tokens": meta}, mesh)
    t = c.totals
    print(json.dumps([t.flops, t.bytes, c.peak_bytes, t.coll_counts,
                      c.calls, p.totals.coll_counts]))
    """)
    flops, nbytes, peak, coll, calls, prefill = json.loads(out)
    assert flops > 0 and nbytes > 0 and peak > 0
    # a forward and a recompute a layer
    assert calls == {"flash_attention": 4, "flash_attention_bwd": 2}
    assert coll == {"all-gather": 44, "reduce-scatter": 28,
                    "all-reduce": 13, "all-to-all": 2}
    assert prefill == {"all-gather": 27, "reduce-scatter": 5}


@pytest.mark.parametrize("shape", tuple(SHAPES))
def test_config_functions_equal_reference(shape):
    for a in ARCH_IDS:
        cfg, jcfg = get_config(a), jget_config(a)
        assert roofline.model_flops(cfg, shape) == \
            jroofline.model_flops(jcfg, shape)
        for chips in (1, 256, 512):
            assert roofline.analytic_decode_bytes(cfg, shape, chips) == \
                jroofline.analytic_decode_bytes(jcfg, shape, chips)


def test_flops_within_5_percent_of_reference_walker():
    """Reduced qwen2 with heads widened to 64, prefill of 4 x 32 tokens on
    one device: the counter against the reference's walker (about 1.109 G
    at 2 layers and 2.217 G at 4)."""
    walker = run_subprocess("""
    import dataclasses, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.distributed import hlo_cost
    from repro.models import get_model
    base = get_config("qwen2-0.5b", reduced=True)
    for L in (2, 4):
        cfg = dataclasses.replace(base, d_model=base.n_heads * 64,
                                  head_dim=0, n_layers=L)
        m = get_model(cfg)
        p = jax.eval_shape(lambda k: m.init(k)[0], jax.random.PRNGKey(0))
        b = {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)}
        c = jax.jit(m.prefill).lower(p, b).compile()
        print(hlo_cost.analyze(c.as_text()).flops)
    """, devices=1).split()
    base = widen_heads(get_config("qwen2-0.5b", reduced=True))
    for L, want in zip((2, 4), walker):
        cfg = dataclasses.replace(base, n_layers=L)
        m = get_model(cfg)
        gen = torch.Generator()
        params = m.init(gen, "cpu")
        with torch.no_grad(), CostCounter() as c:
            m.prefill(params, {"tokens": torch.zeros((4, 32),
                                                     dtype=torch.long)})
        assert c.totals.flops == pytest.approx(float(want), rel=0.05)


def test_dryrun_cell_and_latency_model(tmp_path):
    """One full-width cell through the CLI: ``ok``, peak under 80 GiB a
    device, read by ``RooflineLatencyModel.from_artifact``; a skipped
    cell written with the reference's reason."""
    _port(f"""
    from repro_torch.launch.dryrun import main
    assert main(["--arch", "qwen2-0.5b", "--shape", "train_4k",
                 "--out", {str(tmp_path)!r}]) == 0
    assert main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--out", {str(tmp_path)!r}]) == 0
    """)
    rec = json.loads((tmp_path / "qwen2-0.5b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert 0 < rec["memory"]["peak_bytes"] < 80 * 2**30
    r = rec["roofline"]
    assert r["flops_dev"] > 0 and r["wire_ici"] > 0 and r["wire_dcn"] == 0
    assert r["model_flops"] == roofline.model_flops(get_config("qwen2-0.5b"),
                                                    "train_4k")
    assert rec["tags"]["calls"] == {"flash_attention": 48,
                                    "flash_attention_bwd": 24}
    m = RooflineLatencyModel.from_artifact(
        str(tmp_path / "qwen2-0.5b__train_4k__single.json"))
    assert m.anchor_width == 256
    assert m.t_scale == pytest.approx((r["t_compute"] + r["t_memory"]) * 256)
    assert m.t_coll == pytest.approx(r["t_collective"] * 256 / 255)
    skip = json.loads((tmp_path / "hubert-xlarge__decode_32k__single.json")
                      .read_text())
    assert skip["status"] == "skipped"
    assert skip["reason"] == "encoder-only arch has no decode step"


def test_latency_model_shape():
    m = RooflineLatencyModel(t_scale=1.6, t_fixed=0.0, t_coll=0.2,
                             anchor_width=16)
    lats = [m.latency(w) for w in (1, 2, 4, 8, 16)]
    assert all(a > b for a, b in zip(lats, lats[1:])), lats
    assert lats[-1] >= 0.2 * 15 / 16


def test_latency_model_from_artifact_round_trip(tmp_path):
    rf = roofline.Roofline("a", "train_4k", "single", 16, 1e12, 1e9, 1e6,
                           2e8, 0.0, 1e13, 1)
    path = tmp_path / "cell.json"
    path.write_text(json.dumps({"chips": 16, "roofline": rf.to_dict()}))
    m = RooflineLatencyModel.from_artifact(str(path))
    assert m.anchor_width == 16
    assert m.latency(16) == pytest.approx(rf.t_compute + rf.t_memory
                                          + rf.t_collective)
    one = tmp_path / "one.json"
    one.write_text(json.dumps({"chips": 1, "roofline": rf.to_dict()}))
    assert RooflineLatencyModel.from_artifact(str(one)).t_coll == 0.0


def test_kernel_calls_priced_once():
    """A kernel call is priced with its own FLOPs and bytes, not its plain
    version's: ``flash_attention`` at 2 x 64 queries, 4/2 heads of 64,
    causal."""
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(2, 4, 64, 64)
    k = v = torch.randn(2, 2, 64, 64)
    with CostCounter() as c:
        flash_attention(q, k, v, causal=True)
    assert c.calls == {"flash_attention": 1}
    assert c.totals.flops == 4 * 2 * 4 * 64 * (64 * 65 // 2)
    assert c.totals.bytes == (q.numel() + 2 * k.numel() + q.numel()) * 4
    assert c.totals.tag_flops == {"flash_attention": c.totals.flops}
