"""Static analysis and model audit: the CI gate for the port's serving
invariants.  Counterpart of ``repro.analysis``, retargeted to
``src/repro_torch``, in three layers:

* **Layer 1 — AST lint** (:mod:`repro_torch.analysis.lint`): the
  reference's rules over the port's tree — host syncs in the engine's
  decode/prefill hot path (``hot-path-host-sync``, with the torch syncs:
  ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``torch.cuda.synchronize`` and ``int()`` / ``float()`` / ``bool()`` of a
  tensor), ``wall-clock-latency``, ``unguarded-span``, ``wire-compat``,
  ``bare-retry``, ``metric-cardinality``, and kernel packages missing
  their ``csrc/*.cu`` / ``ops.py`` / ``ref.py`` triad or a
  ``tests/test_torch_*.py`` naming them (``kernel-triad``).
* **Layer 2 — model audit** (:mod:`repro_torch.analysis.audit`): calls
  ``Model.decode_fused`` / ``Model.prefill_chunk`` of every family and
  checks that each cache tensor keeps its ``data_ptr`` (the in-place cache
  that replaces donation), that no op returns float64, and that nothing
  syncs the host inside the call.
* **Layer 3 — contract checker** (:mod:`repro_torch.analysis.contracts`):
  every :class:`~repro_torch.core.tracetable.CostModel` /
  :class:`~repro_torch.core.tracetable.SearchPolicy` keeps its surface and
  ``sum(cost_terms) == cost``, and every serving facade's ``stats()``
  exposes :data:`repro_torch.obs.CANONICAL_STATS`.

Findings render as JSON or human text and gate against a baseline file;
``python -m repro_torch.analysis`` exits non-zero on any new finding.  The
port's tree is kept clean, so it has no baseline file.  Intended one-off
violations are annotated in-source (``# analysis: allow-<rule>(reason)``).
"""

from .findings import (SEVERITY_ERROR, SEVERITY_WARNING, Baseline, Finding,
                       render_human, render_json)

__all__ = [
    "Baseline", "Finding", "SEVERITY_ERROR", "SEVERITY_WARNING",
    "render_human", "render_json",
]
