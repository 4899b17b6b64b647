"""Layer 1 — codebase-specific AST lint rules, over the port's tree.

The port's copy of ``repro.analysis.lint``: the same rules and annotation
tokens, retargeted to ``src/repro_torch``.  Every rule here encodes an
invariant the serving stack paid for:

* ``hot-path-host-sync`` — the decode chunk loop makes one host sync a
  chunk.  Any ``np.asarray`` / ``torch.cuda.synchronize`` / ``.item()`` /
  ``.cpu()`` / ``.tolist()`` / ``.numpy()`` / ``.synchronize()``, and any
  ``int()`` / ``float()`` / ``bool()`` applied directly to a ``torch.*``
  call or a tensor-method call (``int(torch.argmax(x))`` copies a scalar
  to the host), inside a function reachable from the
  :class:`~repro_torch.serve.engine.ServeEngine` decode-chunk/prefill-chunk
  loops (``step`` / ``_advance_prefill``) is flagged unless the site is
  annotated as an intended sync.  The rule sees no types: a host array
  through ``np.asarray`` is flagged too, and is annotated where meant.
* ``wall-clock-latency`` — every latency sample the TraceTable learns from
  must come from a monotonic clock; ``time.time()`` jumps with NTP slews
  and measures the wrong thing.  Use ``time.perf_counter()`` (or
  ``time.monotonic()``); annotate the rare site that genuinely wants a
  wall-clock *timestamp*.
* ``unguarded-span`` — the instrumented decode path stays near the null
  path only because hot-path span emission hides behind one
  ``tracer.enabled`` check and metric children are resolved outside the
  loop.  Span emission not behind the guard, or metric
  *creation* (registry lookups) inside a hot-path function, is flagged.
* ``wire-compat`` — a module defining ``WIRE_VERSION`` must keep it inside
  its literal ``WIRE_COMPAT`` set: a version bump without a compat-set
  edit would make every current writer's payload unreadable to itself.
* ``kernel-triad`` — every ``kernels/*/`` package ships its CUDA source
  (``csrc/*.cu``), ``ops.py`` and ``ref.py``, and a ``tests/test_torch_*.py``
  file names the package, so no kernel exists without a plain version and
  a parity test.  The port's ops have no switch (a CUDA tensor launches the
  kernel, a CPU tensor takes the plain version), so there is no
  ``force_pallas`` surface to require.
* ``bare-retry`` — the chaos plane shows every delivery failure is
  survivable *because* retries are bounded and spread out: a ``while``
  loop that swallows an exception and goes around again (``except: ...
  continue``/``pass``) with no backoff, jitter, or exhaustion exit
  hammers a failing dependency in lockstep with every other retrying
  sender.  ``for _ in range(n)`` loops are structurally capped and never
  flagged; see :class:`repro_torch.chaos.ReliableTransport` for the sanctioned
  shape.
* ``metric-cardinality`` — every distinct (name, labels) pair is a child
  the registry keeps forever and the TimeSeriesStore rings per series.
  A metric *name* built by interpolation, or a label fed from unbounded
  runtime data (an f-string, ``str()``/``.format()`` of a variable, or a
  per-request id like ``rid``/``session_id``), grows the registry without
  bound — ids belong on the tracer (spans are bounded deques), labels
  name *dimensions* (replica index, fleet, state), not *events*.

Intended one-off violations are annotated in-source on the offending
line::

    toks = np.asarray(toks_dev)   # analysis: allow-host-sync(reason)

Annotation tokens: ``allow-host-sync``, ``allow-wall-clock``,
``allow-unguarded-span``, ``allow-bare-retry``,
``allow-metric-cardinality``.
"""

from __future__ import annotations

import ast
import glob
import os
import re

from .findings import SEVERITY_ERROR, SEVERITY_WARNING, Finding

# -- annotations -------------------------------------------------------------

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow-([a-z0-9-]+)")


def allowed_lines(source: str) -> dict[int, set]:
    """1-indexed line -> set of ``allow-*`` tokens found on that line."""
    out: dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), 1):
        for m in _ALLOW_RE.finditer(line):
            out.setdefault(i, set()).add(m.group(1))
    return out


def _is_allowed(node: ast.AST, allows: dict[int, set], token: str) -> bool:
    end = getattr(node, "end_lineno", node.lineno)
    return any(token in allows.get(ln, ())
               for ln in range(node.lineno, end + 1))


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of a pure attribute chain (``self.tracer.instant``),
    or "" when the expression is anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# -- hot-path-host-sync / unguarded-span -------------------------------------

HOT_PATH_FILE = "src/repro_torch/serve/engine.py"
HOT_PATH_CLASS = "ServeEngine"
# the decode-chunk and prefill-chunk loops: everything the engine runs per
# step is reachable from these two
HOT_PATH_SEEDS = ("step", "_advance_prefill")

_SYNC_CALLS = {"np.asarray", "numpy.asarray", "torch.cuda.synchronize"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# int(x) / float(x) / bool(x) of a device tensor copies it to the host
_SCALAR_CASTS = {"int", "float", "bool"}
# roots of a method call that is not a tensor's: host modules and the
# engine itself
_HOST_ROOTS = {"np", "numpy", "math", "time", "os", "self"}
_SPAN_METHODS = {"complete", "instant", "span", "begin", "end"}
_METRIC_FACTORIES = {"counter", "gauge", "histogram"}


def _function_tables(tree: ast.Module, class_name: str):
    """(module-level functions, methods of ``class_name``) by name."""
    funcs = {n.name: n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    methods: dict[str, ast.FunctionDef] = {}
    for n in tree.body:
        if isinstance(n, ast.ClassDef) and n.name == class_name:
            for m in n.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods[m.name] = m
    return funcs, methods


def _reachable(funcs: dict, methods: dict, seeds) -> dict:
    """BFS the static call graph: ``self.x(...)`` edges into methods,
    bare-name calls into same-module functions.  External calls (model,
    scheduler, model calls) are boundaries — the audit layer
    (:mod:`repro_torch.analysis.audit`) owns what happens inside the
    model."""
    seen: dict[str, ast.FunctionDef] = {}
    frontier = [s for s in seeds if s in methods or s in funcs]
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        fn = methods.get(name, funcs.get(name))
        seen[name] = fn
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self" and f.attr in methods):
                frontier.append(f.attr)
            elif isinstance(f, ast.Name) and f.id in funcs:
                frontier.append(f.id)
    return seen


def _span_guarded(path_to_node: list) -> bool:
    """Whether any enclosing ``if`` on the way to the node tests
    ``*.enabled`` (the sanctioned hot-path span guard).  Only the taken
    branch counts: ``if tracer.enabled: ...`` guards its body, not its
    ``else``."""
    for anc, child in zip(path_to_node, path_to_node[1:]):
        if isinstance(anc, ast.If) and child in anc.body:
            if any(isinstance(t, ast.Attribute) and t.attr == "enabled"
                   for t in ast.walk(anc.test)):
                return True
    return False


def _walk_with_path(node: ast.AST, path=()):
    yield path + (node,)
    for child in ast.iter_child_nodes(node):
        yield from _walk_with_path(child, path + (node,))


def _scalar_cast(node: ast.Call) -> bool:
    """``int(...)`` / ``float(...)`` / ``bool(...)`` applied directly to a
    ``torch.*`` call or a method call on something other than a host
    module or ``self``: a scalar read back from a tensor."""
    if (not isinstance(node.func, ast.Name)
            or node.func.id not in _SCALAR_CASTS or len(node.args) != 1
            or not isinstance(node.args[0], ast.Call)):
        return False
    inner = node.args[0].func
    if not isinstance(inner, ast.Attribute):
        return False
    chain = _attr_chain(inner)
    if chain.startswith("torch."):
        return True
    root = inner
    while isinstance(root, ast.Attribute):
        root = root.value
    return not (isinstance(root, ast.Name) and root.id in _HOST_ROOTS)


def lint_hot_path(source: str, path: str, *,
                  class_name: str = HOT_PATH_CLASS,
                  seeds=HOT_PATH_SEEDS) -> list:
    """``hot-path-host-sync`` + ``unguarded-span`` over one file's
    hot-path reachable set."""
    tree = ast.parse(source)
    allows = allowed_lines(source)
    funcs, methods = _function_tables(tree, class_name)
    findings = []
    for fname, fn in _reachable(funcs, methods, seeds).items():
        for node_path in _walk_with_path(fn):
            node = node_path[-1]
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            cast = _scalar_cast(node)
            is_sync = (chain in _SYNC_CALLS or cast
                       or (isinstance(node.func, ast.Attribute)
                           and node.func.attr in _SYNC_METHODS))
            if is_sync and not _is_allowed(node, allows, "host-sync"):
                what = (f"{node.func.id}() of a tensor" if cast
                        else chain or f".{node.func.attr}()")
                findings.append(Finding(
                    "hot-path-host-sync", SEVERITY_ERROR, path, node.lineno,
                    f"{what} in {fname}() (reachable from the decode/"
                    f"prefill chunk loop) forces a device sync; the chunk "
                    f"loop is one-sync-per-chunk — annotate "
                    f"'# analysis: allow-host-sync(reason)' if intended"))
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SPAN_METHODS
                    and ".tracer" in f".{chain}"
                    and not _span_guarded(node_path)
                    and not _is_allowed(node, allows, "unguarded-span")):
                findings.append(Finding(
                    "unguarded-span", SEVERITY_WARNING, path, node.lineno,
                    f"tracer.{node.func.attr}() in hot-path {fname}() is "
                    f"not behind a tracer.enabled guard — null-tracer "
                    f"overhead is CI-bounded only because spans hide "
                    f"behind one enabled check"))
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_FACTORIES
                    and ("metrics" in chain or "registry" in chain)
                    and not _is_allowed(node, allows, "unguarded-span")):
                findings.append(Finding(
                    "unguarded-span", SEVERITY_WARNING, path, node.lineno,
                    f"metric child creation ({chain}) in "
                    f"hot-path {fname}() — resolve children once in "
                    f"attach_obs and pay a float add in the loop, not a "
                    f"registry lookup"))
    return findings


# -- wall-clock-latency ------------------------------------------------------

def lint_wall_clock(source: str, path: str) -> list:
    tree = ast.parse(source)
    allows = allowed_lines(source)
    findings = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and _attr_chain(node.func) == "time.time"
                and not _is_allowed(node, allows, "wall-clock")):
            findings.append(Finding(
                "wall-clock-latency", SEVERITY_WARNING, path, node.lineno,
                "time.time() is wall clock (NTP slews corrupt duration "
                "samples) — use time.perf_counter()/time.monotonic() for "
                "durations, or annotate "
                "'# analysis: allow-wall-clock(reason)' for a genuine "
                "timestamp"))
    return findings


# -- wire-compat -------------------------------------------------------------

def _literal_int(node) -> int | None:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, int)) else None


def _literal_int_set(node) -> set | None:
    """Ints of ``{1, 2, 3}`` / ``frozenset({1, 2, 3})`` / ``frozenset((…))``
    literals; None when the expression is anything else."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("frozenset", "set") and node.args):
        node = node.args[0]
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        vals = [_literal_int(e) for e in node.elts]
        if all(v is not None for v in vals):
            return set(vals)
    return None


def lint_wire_compat(source: str, path: str) -> list:
    tree = ast.parse(source)
    version = compat = None
    version_line = 0
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
            if name == "WIRE_VERSION":
                version = _literal_int(node.value)
                version_line = node.lineno
            elif name == "WIRE_COMPAT":
                compat = _literal_int_set(node.value)
    if version is None:
        return []
    if compat is None:
        return [Finding(
            "wire-compat", SEVERITY_ERROR, path, version_line,
            f"WIRE_VERSION = {version} without a literal WIRE_COMPAT set "
            f"in the same module — readers cannot know which versions "
            f"decode safely")]
    if version not in compat:
        return [Finding(
            "wire-compat", SEVERITY_ERROR, path, version_line,
            f"WIRE_VERSION = {version} is not in WIRE_COMPAT "
            f"{sorted(compat)} — a version bump requires a matching "
            f"compat-set edit (every writer must read its own payloads)")]
    return []


# -- bare-retry --------------------------------------------------------------

_BACKOFF_HINTS = ("backoff", "jitter")


def _swallow_handlers(loop: ast.While) -> list:
    """Except handlers inside ``loop`` whose body ends in ``continue`` or
    ``pass`` — the failure is absorbed and the loop just goes around
    again.  Handlers inside a NESTED loop belong to that loop, not this
    one."""
    out = []
    stack: list[ast.AST] = list(loop.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.While, ast.For, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Try):
            for h in node.handlers:
                if isinstance(h.body[-1], (ast.Continue, ast.Pass)):
                    out.append(h)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _has_retry_discipline(loop: ast.While) -> bool:
    """Any signal that the retry loop is bounded or spread out: a name
    mentioning backoff/jitter, geometric growth (``*=``/``**=``), or a
    ``raise`` that gives the loop an exhaustion exit."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Name) and any(
                h in node.id.lower() for h in _BACKOFF_HINTS):
            return True
        if isinstance(node, ast.Attribute) and any(
                h in node.attr.lower() for h in _BACKOFF_HINTS):
            return True
        if isinstance(node, ast.AugAssign) and isinstance(
                node.op, (ast.Mult, ast.Pow)):
            return True
        if isinstance(node, ast.Raise):
            return True
    return False


def lint_bare_retry(source: str, path: str) -> list:
    tree = ast.parse(source)
    allows = allowed_lines(source)
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.While):
            continue
        handlers = _swallow_handlers(node)
        if not handlers or _has_retry_discipline(node):
            continue
        for h in handlers:
            if (_is_allowed(h, allows, "bare-retry")
                    or _is_allowed(node, {node.lineno: allows.get(
                        node.lineno, set())}, "bare-retry")):
                continue
            findings.append(Finding(
                "bare-retry", SEVERITY_WARNING, path, h.lineno,
                "retry loop swallows the failure and goes around again "
                "with no backoff, jitter, or attempt cap — N such senders "
                "re-collide in lockstep; use capped exponential backoff "
                "with jitter (repro_torch.chaos.ReliableTransport is the "
                "sanctioned shape), a bounded 'for ... in range(n)' "
                "loop, or annotate "
                "'# analysis: allow-bare-retry(reason)'"))
    return findings


# -- metric-cardinality ------------------------------------------------------

#: Label/value names that are per-event identifiers, not dimensions.
_ID_NAME_RE = re.compile(
    r"(?:^|_)(rid|request_id|session_id|trace_id|span_id|tid|uuid)$")
_STRINGIFY_FUNCS = {"str", "repr", "format", "hex"}


def _unbounded_reason(node: ast.AST) -> str | None:
    """Why a metric-name / label-value expression looks unbounded, or
    None when it is safely low-cardinality (a literal, or a plain
    variable whose name is not id-like).  A bare variable is trusted —
    loop indices over replicas/fleets are the normal label idiom — but
    anything *stringified or interpolated at the call site* is the
    telltale of event data being minted into a series."""
    if isinstance(node, ast.Constant):
        return None
    if isinstance(node, ast.JoinedStr):
        return "an f-string interpolation"
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mod)):
        return "string concatenation/%-formatting"
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in _STRINGIFY_FUNCS:
            return f"{f.id}() of a runtime value"
        if isinstance(f, ast.Attribute) and f.attr == "format":
            return "a .format() interpolation"
        return None
    name = (node.id if isinstance(node, ast.Name)
            else node.attr if isinstance(node, ast.Attribute) else "")
    if name and _ID_NAME_RE.search(name.lower()):
        return f"the per-request id {name!r}"
    return None


def _is_metric_factory(node: ast.Call) -> bool:
    """A ``counter``/``gauge``/``histogram`` call on something that looks
    like a registry (``metrics.counter``, ``self.registry.gauge``,
    ``reg.histogram``, ``store.registry.counter``)."""
    if (not isinstance(node.func, ast.Attribute)
            or node.func.attr not in _METRIC_FACTORIES):
        return False
    chain = _attr_chain(node.func).lower()
    return any(h in chain for h in ("metric", "registry", "reg."))


def lint_metric_cardinality(source: str, path: str) -> list:
    tree = ast.parse(source)
    allows = allowed_lines(source)
    findings = []
    for node in ast.walk(tree):
        if (not isinstance(node, ast.Call) or not _is_metric_factory(node)
                or _is_allowed(node, allows, "metric-cardinality")):
            continue
        factory = node.func.attr
        if node.args:
            why = _unbounded_reason(node.args[0])
            if why:
                findings.append(Finding(
                    "metric-cardinality", SEVERITY_WARNING, path,
                    node.lineno,
                    f"metric name passed to .{factory}() is {why} — every "
                    f"distinct name is a family kept forever; make the "
                    f"name a literal and move the variable part into a "
                    f"label, or annotate "
                    f"'# analysis: allow-metric-cardinality(reason)'"))
        for kw in node.keywords:
            if kw.arg is None:        # **labels splat: opaque, let it pass
                continue
            why = _unbounded_reason(kw.value)
            if why:
                findings.append(Finding(
                    "metric-cardinality", SEVERITY_WARNING, path,
                    kw.value.lineno,
                    f"label {kw.arg!r} on .{factory}() is fed from {why} — "
                    f"every distinct value is a child series the registry "
                    f"(and any TimeSeriesStore ring) keeps forever; labels "
                    f"name bounded dimensions, per-event ids belong on "
                    f"the tracer, or annotate "
                    f"'# analysis: allow-metric-cardinality(reason)'"))
    return findings


# -- kernel-triad ------------------------------------------------------------

_TRIAD = ("ops.py", "ref.py")


def lint_kernel_triad(root: str,
                      kernels_rel: str = "src/repro_torch/kernels",
                      tests_glob: str = "tests/test_torch_*.py") -> list:
    kdir = os.path.join(root, kernels_rel)
    if not os.path.isdir(kdir):
        return []
    test_text = ""
    for full in sorted(glob.glob(os.path.join(root, tests_glob))):
        with open(full) as f:
            test_text += f.read()
    findings = []
    for name in sorted(os.listdir(kdir)):
        pkg = os.path.join(kdir, name)
        if (not os.path.isdir(pkg)
                or not os.path.isfile(os.path.join(pkg, "__init__.py"))):
            continue
        rel = f"{kernels_rel}/{name}"
        if not glob.glob(os.path.join(pkg, "csrc", "*.cu")):
            findings.append(Finding(
                "kernel-triad", SEVERITY_ERROR, rel, 0,
                f"kernel package {name!r} has no csrc/*.cu — every kernel "
                f"package ships its hand-written CUDA source"))
        for part in _TRIAD:
            if not os.path.isfile(os.path.join(pkg, part)):
                findings.append(Finding(
                    "kernel-triad", SEVERITY_ERROR, rel, 0,
                    f"kernel package {name!r} is missing {part} — every "
                    f"kernel ships the csrc/ops/ref triad so the CUDA "
                    f"path always has a plain PyTorch version"))
        if name not in test_text:
            findings.append(Finding(
                "kernel-triad", SEVERITY_ERROR, rel, 0,
                f"no {tests_glob} file names kernel package {name!r} — "
                f"every kernel needs a kernel-vs-ref parity test"))
    return findings


# -- entry point -------------------------------------------------------------

#: Directories (repo-relative) the per-file rules sweep.  Tests are
#: excluded by design: fixture snippets there deliberately violate rules.
DEFAULT_ROOTS = ("src/repro_torch",)


def iter_py_files(root: str, rel_dirs=DEFAULT_ROOTS):
    for rel in rel_dirs:
        top = os.path.join(root, rel)
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fname in sorted(filenames):
                if fname.endswith(".py"):
                    full = os.path.join(dirpath, fname)
                    yield full, os.path.relpath(full, root).replace(
                        os.sep, "/")


def run_lint(root: str, rel_dirs=DEFAULT_ROOTS) -> list:
    """All layer-1 rules over the tree rooted at ``root``."""
    findings = []
    for full, rel in iter_py_files(root, rel_dirs):
        with open(full) as f:
            source = f.read()
        try:
            findings += lint_wall_clock(source, rel)
            findings += lint_wire_compat(source, rel)
            findings += lint_bare_retry(source, rel)
            findings += lint_metric_cardinality(source, rel)
            if rel == HOT_PATH_FILE:
                findings += lint_hot_path(source, rel)
        except SyntaxError as e:
            findings.append(Finding(
                "parse-error", SEVERITY_ERROR, rel, e.lineno or 0,
                f"file does not parse: {e.msg}"))
    findings += lint_kernel_triad(root)
    return findings
