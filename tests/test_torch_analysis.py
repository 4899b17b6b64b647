"""The port's analysis suite (``repro_torch.analysis``) on the CPU: every
lint rule catches its broken snippet and spares its guarded or annotated
twin (snippets written to ``tmp_path`` from the strings here, the whole
CLI run over that tree), ``int(torch.argmax(x))`` in the hot path is
flagged, the kernel triad is checked against a tree built here, the
baseline gates and needs a reason, the port's own tree lints clean and its
contracts hold, a cost model that breaks additivity is caught, and the
model audit passes on each family's widened reduced config, fails on a model
that copies its cache, one that returns a float64 and one that calls
``.item()`` inside ``decode_fused`` (the counterpart of the reference's
``test_donation_audit_fails_when_donation_dropped``).

The rules, findings and contracts the port shares with the JAX package's
``repro.analysis`` are held against it on the same inputs: each shared
rule gives the same (rule, line, severity) list on every snippet here, the
hot-path rule agrees on the syncs both know (``np.asarray``,
``numpy.asarray``, ``.item()``) while the torch-only ones are the port's
alone, the two packages render and baseline one set of findings to the
same text, and every cost model and search policy of the two tracetables
scores and picks the same on the contract checker's synthetic inputs.
"""

import contextlib
import dataclasses
import io
import json
import os
import textwrap

import pytest
import torch

import repro.analysis.contracts as ref_contracts
import repro.analysis.findings as ref_findings
import repro.analysis.lint as ref_lint
from repro_torch.analysis import Baseline, Finding
from repro_torch.analysis import findings as F
from repro_torch.analysis import lint as L
from repro_torch.analysis import audit as A
from repro_torch.analysis import contracts as C
from repro_torch.analysis.cli import main as analysis_main
from repro_torch.analysis.lint import (HOT_PATH_FILE, lint_bare_retry,
                                       lint_hot_path, lint_kernel_triad,
                                       lint_metric_cardinality,
                                       lint_wall_clock, lint_wire_compat,
                                       run_lint)
from repro_torch.configs import get_config
from repro_torch.models import get_model

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _cli(argv) -> tuple:
    """(exit_code, stdout) of one in-process CLI invocation."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(argv)
    return rc, buf.getvalue()


_HOT = textwrap.dedent("""\
    import numpy as np
    import torch

    class ServeEngine:
        def step(self):
            toks = self._chunk()
            %s
            return toks

        def _chunk(self):
            return [1]
    """)

# each sync the port's rule knows, and a line it must leave alone
SYNCS = {
    "np.asarray": "out = np.asarray(toks)",
    "torch.cuda.synchronize": "torch.cuda.synchronize(self.device)",
    ".item()": "n = toks.item()",
    ".cpu()": "h = toks.cpu()",
    ".tolist()": "h = toks.tolist()",
    ".numpy()": "h = self.dev_toks.numpy()",
    ".synchronize()": "self.stream.synchronize()",
    "int(torch.argmax)": "t = int(torch.argmax(x))",
    "float(tensor method)": "v = float(logits.max())",
    "bool(tensor method)": "b = bool((pos >= 3).any())",
}
NOT_SYNCS = ("n = int(len(toks))", "n = int(self.count())",
             "n = float(np.sum(toks))", "n = int(toks[0])",
             "n = int(42)")
# the syncs the reference's rule knows too (its others, jax.device_get and
# .block_until_ready(), have no torch counterpart)
SHARED_SYNCS = ("np.asarray", ".item()")


def _key(findings) -> list:
    return [(f.rule, f.line, f.severity) for f in findings]


@pytest.mark.parametrize("what", sorted(SYNCS))
def test_hot_path_sync_flagged_and_annotation_spares(what):
    bad = lint_hot_path(_HOT % SYNCS[what], "engine.py")
    assert [f.rule for f in bad] == ["hot-path-host-sync"]
    assert bad[0].line == 7
    ok = lint_hot_path(
        _HOT % (SYNCS[what] + "  # analysis: allow-host-sync(intended)"),
        "engine.py")
    assert ok == []
    # the reference agrees on the syncs it knows and misses the rest
    ref = ref_lint.lint_hot_path(_HOT % SYNCS[what], "engine.py")
    assert _key(ref) == (_key(bad) if what in SHARED_SYNCS else [])


@pytest.mark.parametrize("line", NOT_SYNCS)
def test_hot_path_host_values_not_flagged(line):
    assert lint_hot_path(_HOT % line, "engine.py") == []


def test_hot_path_only_flags_reachable_functions():
    src = _HOT % "pass"
    src += "    def offline_dump(self):\n        return t.cpu()\n"
    assert lint_hot_path(src, "engine.py") == []


def test_unguarded_span_rule():
    guarded = _HOT % ("if self.tracer.enabled:\n"
                      "            self.tracer.instant('x', 1)")
    assert lint_hot_path(guarded, "engine.py") == []
    fs = lint_hot_path(_HOT % "self.tracer.instant('x', 1)", "engine.py")
    assert [f.rule for f in fs] == ["unguarded-span"]
    fs = lint_hot_path(_HOT % "c = self.metrics.counter('a', 'b')",
                       "engine.py")
    assert [f.rule for f in fs] == ["unguarded-span"]


WALL_BAD = "import time\nd = time.time()\n"
WALL_OK = ("import time\nd = time.perf_counter()\nm = time.monotonic()\n"
           "s = time.time()  # analysis: allow-wall-clock(a timestamp)\n")
RETRY_BAD = textwrap.dedent("""\
    while True:
        try:
            ship()
        except IOError:
            continue
    """)
RETRY_OK = (
    RETRY_BAD.replace("continue", "if delay > 2.0:\n            raise\n"
                                  "        delay *= 2\n        continue"),
    RETRY_BAD.replace("while True:", "for _ in range(3):"),
    RETRY_BAD.replace("continue", "# analysis: allow-bare-retry(local)\n"
                                  "        continue"))
METRIC_BAD = textwrap.dedent("""\
    def attach(metrics, req):
        metrics.counter(f"requests_{req.rid}_total", "per request")
        metrics.histogram("lat_seconds", "l", rid=req.rid)
    """)
METRIC_OK = textwrap.dedent("""\
    def attach(metrics, g):
        metrics.gauge("drift_ratio", "d", fleet=g, replica=0)
    """)
WIRE_OK = "WIRE_VERSION = 3\nWIRE_COMPAT = frozenset({1, 2, 3})\n"
WIRE_BAD = ("WIRE_VERSION = 4\nWIRE_COMPAT = frozenset({1, 2, 3})\n",
            "WIRE_VERSION = 4\n")


def test_wall_clock_rule():
    fs = lint_wall_clock(WALL_BAD, "x.py")
    assert [f.rule for f in fs] == ["wall-clock-latency"]
    assert lint_wall_clock(WALL_OK, "x.py") == []


def test_bare_retry_rule():
    assert [f.rule for f in lint_bare_retry(RETRY_BAD, "x.py")] == [
        "bare-retry"]
    for ok in RETRY_OK:
        assert lint_bare_retry(ok, "x.py") == []


def test_metric_cardinality_rule():
    fs = lint_metric_cardinality(METRIC_BAD, "x.py")
    assert [f.line for f in fs] == [2, 3]
    assert lint_metric_cardinality(METRIC_OK, "x.py") == []


def test_wire_compat_rule():
    assert lint_wire_compat(WIRE_OK, "wire.py") == []
    for bad in WIRE_BAD:
        assert [f.rule for f in lint_wire_compat(bad, "wire.py")] == [
            "wire-compat"]


# every snippet of the shared rules, with the hot path's shared syncs (bare
# and annotated), its host values, spans and an unreachable method
PARITY_CASES = [
    *(("lint_hot_path", _HOT % line) for line in (
        "out = np.asarray(toks)", "out = numpy.asarray(toks)",
        "n = toks.item()",
        "out = np.asarray(toks)  # analysis: allow-host-sync(intended)",
        "n = toks.item()  # analysis: allow-host-sync(intended)",
        *NOT_SYNCS, "pass",
        "self.tracer.instant('x', 1)",
        "c = self.metrics.counter('a', 'b')",
        "if self.tracer.enabled:\n            self.tracer.instant('x', 1)",
        "n = self._chunk()[0]\n        out = np.asarray(n)")),
    ("lint_hot_path", _HOT % "pass"
     + "    def offline_dump(self):\n        return np.asarray(t)\n"),
    ("lint_wall_clock", WALL_BAD), ("lint_wall_clock", WALL_OK),
    ("lint_bare_retry", RETRY_BAD),
    *(("lint_bare_retry", ok) for ok in RETRY_OK),
    ("lint_metric_cardinality", METRIC_BAD),
    ("lint_metric_cardinality", METRIC_OK),
    ("lint_wire_compat", WIRE_OK),
    *(("lint_wire_compat", bad) for bad in WIRE_BAD),
]


@pytest.mark.parametrize("rule,source", PARITY_CASES,
                         ids=[f"{r}-{i}" for i, (r, _) in
                              enumerate(PARITY_CASES)])
def test_shared_rule_agrees_with_reference(rule, source):
    """The port's rule and the JAX package's, on the same snippet, give
    the same (rule, line, severity) list."""
    got = _key(getattr(L, rule)(source, "x.py"))
    assert got == _key(getattr(ref_lint, rule)(source, "x.py"))
    assert L.allowed_lines(source) == ref_lint.allowed_lines(source)


def _write(root, rel, text=""):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _kernel_tree(root):
    """A kernels folder with one complete package and one missing each
    part of the triad, and a test file naming only the complete one."""
    k = "src/repro_torch/kernels"
    for name, parts in (("goodkernel", ("csrc/good.cu", "ops.py", "ref.py")),
                        ("nocuda", ("ops.py", "ref.py")),
                        ("noops", ("csrc/x.cu", "ref.py")),
                        ("noref", ("csrc/x.cu", "ops.py"))):
        _write(root, f"{k}/{name}/__init__.py")
        for p in parts:
            _write(root, f"{k}/{name}/{p}")
    _write(root, f"{k}/csrc/shared.cuh")        # not a package: skipped
    _write(root, "tests/test_torch_good.py",
           "from repro_torch.kernels import goodkernel, nocuda, noops\n")


def test_kernel_triad_rule(tmp_path):
    _kernel_tree(tmp_path)
    got = sorted((f.path.rsplit("/", 1)[-1], f.message.split(" — ")[0])
                 for f in lint_kernel_triad(str(tmp_path)))
    assert got == [
        ("nocuda", "kernel package 'nocuda' has no csrc/*.cu"),
        ("noops", "kernel package 'noops' is missing ops.py"),
        ("noref", "kernel package 'noref' is missing ref.py"),
        ("noref", "no tests/test_torch_*.py file names kernel package "
                  "'noref'"),
    ]


def _broken_tree(root):
    """One snippet per per-file rule under the lint root, the hot path at
    the engine's own path."""
    _write(root, HOT_PATH_FILE,
           _HOT % "t = int(torch.argmax(x))\n"
                  "        self.tracer.instant('x', 1)")
    _write(root, "src/repro_torch/a.py", "import time\nd = time.time()\n")
    _write(root, "src/repro_torch/wire.py", "WIRE_VERSION = 4\n")
    _write(root, "src/repro_torch/retry.py",
           "while True:\n    try:\n        f()\n    except OSError:\n"
           "        continue\n")
    _write(root, "src/repro_torch/m.py",
           "metrics.counter(f'x_{rid}', 'y')\n")
    _write(root, "src/repro_torch/bad.py", "def (:\n")
    _kernel_tree(root)
    # outside the lint root: never swept
    _write(root, "examples/e.py", "import time\nd = time.time()\n")


def test_cli_report_over_broken_tree(tmp_path):
    _broken_tree(tmp_path)
    rc, out = _cli(["--only", "lint", "--root", str(tmp_path),
                    "--format", "json"])
    assert rc == 1
    report = json.loads(out)
    assert {f["rule"] for f in report["findings"]} == {
        "hot-path-host-sync", "unguarded-span", "wall-clock-latency",
        "wire-compat", "kernel-triad", "bare-retry", "metric-cardinality",
        "parse-error"}
    sync = [f for f in report["findings"]
            if f["rule"] == "hot-path-host-sync"]
    assert [(f["path"], f["line"]) for f in sync] == [(HOT_PATH_FILE, 7)]
    assert "int() of a tensor" in sync[0]["message"]
    assert not any(f["path"].startswith("examples/")
                   or "goodkernel" in f["path"] for f in report["findings"])
    assert report["counts"]["new"] == len(report["findings"])


def test_baseline_roundtrip_and_reason(tmp_path):
    f = Finding("wall-clock-latency", "warning", "a.py", 7, "m")
    p = tmp_path / "b.json"
    Baseline.from_findings([f], reason="legacy").dump(p)
    new, suppressed = Baseline.load(p).apply(
        [f, dataclasses.replace(f, message="other")])
    assert [x.message for x in new] == ["other"]
    assert [x.message for x in suppressed] == ["m"]
    assert Baseline.load(p).matches(dataclasses.replace(f, line=99))
    with pytest.raises(ValueError, match="reason"):
        Baseline([{"rule": "x", "path": "a.py"}])


def _finding_pair(module):
    """One set of findings (both severities, a file-scoped one, an
    unsorted order) built from ``module``'s ``Finding``."""
    rows = [("wire-compat", "error", "src/w.py", 3, "bump"),
            ("wall-clock-latency", "warning", "src/a.py", 7, "m"),
            ("kernel-triad", "error", "src/k", 0, "missing ref.py"),
            ("wall-clock-latency", "warning", "src/a.py", 2, "m2")]
    return [module.Finding(*r) for r in rows]


def test_findings_render_and_baseline_as_reference(tmp_path):
    port, ref = _finding_pair(F), _finding_pair(ref_findings)
    assert F.render_json(port, port[:1]) == ref_findings.render_json(
        ref, ref[:1])
    assert F.render_human(port, port[1:2]) == ref_findings.render_human(
        ref, ref[1:2])
    assert [f.render() for f in F.sort_findings(port)] == [
        f.render() for f in ref_findings.sort_findings(ref)]
    # one baseline file, written by each, read by the other
    Baseline.from_findings(port[:2], reason="legacy").dump(tmp_path / "p")
    ref_findings.Baseline.from_findings(ref[:2], reason="legacy").dump(
        tmp_path / "r")
    assert (tmp_path / "p").read_text() == (tmp_path / "r").read_text()
    base = [{"rule": "wall-clock-latency", "path": "src/a.py",
             "reason": "any message"}]
    for p_base, r_base in (
            (Baseline.load(tmp_path / "r"),
             ref_findings.Baseline.load(tmp_path / "p")),
            (Baseline(base), ref_findings.Baseline(base))):
        got = [[f.to_dict() for f in part] for part in p_base.apply(port)]
        want = [[f.to_dict() for f in part] for part in r_base.apply(ref)]
        assert got == want


def test_write_baseline_then_clean(tmp_path):
    _broken_tree(tmp_path)
    bp = str(tmp_path / "baseline.json")
    lint = ["--only", "lint", "--root", str(tmp_path), "--baseline", bp]
    assert _cli(lint + ["--write-baseline"])[0] == 2      # no --reason
    assert _cli(lint + ["--write-baseline", "--reason", "adopting"])[0] == 0
    rc, out = _cli(lint + ["--format", "json"])
    report = json.loads(out)
    assert rc == 0 and report["counts"]["new"] == 0
    assert report["counts"]["baselined"] > 0
    assert _cli(["--only", "nope"])[0] == 2


def test_port_tree_is_clean():
    """The port's tree lints clean with no baseline, and its contracts
    hold (the CLI, as CI runs it, on the CPU)."""
    assert run_lint(REPO_ROOT) == []
    rc, out = _cli(["--only", "lint,contracts", "--root", REPO_ROOT,
                    "--device", "cpu", "--format", "json"])
    assert rc == 0, json.loads(out)["findings"]


def _scores(contracts):
    """Every cost model's (cost, cost_terms) on the checker's synthetic
    inputs, and every search policy's pick, from one package."""
    tt = contracts._tracetable()
    out = {}
    cands = [tt.Candidate(key=(i,), item=i, width=1 + i % 2, tie=float(i))
             for i in range(3)]
    for cls in contracts._cost_model_classes(tt):
        ctor = contracts.SYNTHETIC_CTORS.get(cls.__name__)
        inst = ctor(tt) if ctor else cls()
        out[cls.__name__] = [
            (inst.cost(v, c, ctx), tt.cost_terms(inst, v, c, ctx))
            for ctx in contracts._synthetic_contexts(tt)
            for c in cands for v in (0.0, 0.5, 2.0)]
    scored = [tt.Scored(c, value=0.5 + i, primary=float(3 - i))
              for i, c in enumerate(cands)]
    for cls in contracts._policy_classes(tt):
        picked = cls().select(list(scored), tt.SearchContext(current=0))
        out[cls.__name__] = picked if isinstance(picked, list) else [picked]
    return out


def test_contracts_score_as_reference():
    """The two tracetables' cost models and policies, on the contract
    checker's synthetic contexts, give the same totals, the same
    breakdowns and the same picks."""
    port, ref = _scores(C), _scores(ref_contracts)
    assert sorted(port) == sorted(ref) == [
        "GlobalSearch", "Latency", "MigrationCost", "Occupancy",
        "QueueAware", "RankedSearch", "StickySearch", "WanCost"]
    assert port == ref
    assert C.check_cost_models() == [] and C.check_search_policies() == []


def test_contracts_catch_a_non_additive_cost_model(monkeypatch):
    tt = C._tracetable()

    class Drifting(tt.CostModel):
        """A model with state between calls: re-evaluated, it scores the
        same candidate differently, so its terms cannot sum to its
        total."""

        def __init__(self):
            self.calls = 0

        def cost(self, value, cand, ctx):
            self.calls += 1
            return value + self.calls

    monkeypatch.setattr(tt, "Drifting", Drifting, raising=False)
    msgs = [f.message for f in C.check_cost_models()]
    assert any(m.startswith("Drifting: cost_terms() sums to") for m in msgs)


# ---------------------------------------------------------------------------
# the model audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", A.FAMILY_ARCHS)
def test_audit_clean_for_each_family(arch):
    assert A.audit_family(arch, "cpu") == []


@pytest.fixture(scope="module")
def dense():
    model = get_model(get_config("qwen2-0.5b", reduced=True))
    gen = torch.Generator()
    gen.manual_seed(0)
    return model, model.init(gen, "cpu")


def _copying(fused):
    def f(params, tok, pos, cache, k):
        *out, cache = fused(params, tok, pos, cache, k)
        return (*out, {n: t.clone() for n, t in cache.items()})
    return f


def _float64(fused):
    def f(params, tok, pos, cache, k):
        toks, *rest = fused(params, tok, pos, cache, k)
        return (toks.double().long(), *rest)
    return f


def _item(fused):
    def f(params, tok, pos, cache, k):
        out = fused(params, tok, pos, cache, k)
        if out[0][0, 0].item() < 0:
            raise AssertionError
        return out
    return f


@pytest.mark.parametrize("fault,rule", [(_copying, "moved-cache"),
                                        (_float64, "f64-promotion"),
                                        (_item, "host-sync")])
def test_audit_fails_on_a_faulty_decode(dense, fault, rule):
    model, params = dense
    bad = dataclasses.replace(model, decode_fused=fault(model.decode_fused))
    fs = A.audit_decode_fused(bad, params)
    assert fs and {f.rule for f in fs} == {rule}
    if rule == "moved-cache":
        assert len(fs) == len(model.cache_spec(2, 16))   # every leaf
    assert A.audit_decode_fused(model, params) == []


def test_audit_fails_on_a_prefill_that_copies_its_cache(dense):
    model, params = dense

    def prefill_chunk(params, tokens, cache, start, qlen):
        logits, cache = model.prefill_chunk(params, tokens, cache, start,
                                            qlen)
        return logits, {n: t + 0 for n, t in cache.items()}
    bad = dataclasses.replace(model, prefill_chunk=prefill_chunk)
    assert {f.rule for f in A.audit_prefill_chunk(bad, params)} == {
        "moved-cache"}
