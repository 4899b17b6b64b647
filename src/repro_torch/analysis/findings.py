"""Findings model: what every analysis layer emits, how it renders, and
how the baseline/suppression file gates it.

A :class:`Finding` is (rule id, severity, file:line, message).  Baseline
entries match on the *line-free* fingerprint ``(rule, path, message)`` so
unrelated edits that shift line numbers never resurrect a suppressed
finding; an entry may omit ``message`` to suppress every finding of that
rule in that file (documented escape hatch for rules whose message embeds
volatile detail).  Every baseline entry must carry a ``reason`` — the
suppression file is an audit trail, not a mute button.
"""

from __future__ import annotations

import dataclasses
import json

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"
_SEVERITIES = (SEVERITY_ERROR, SEVERITY_WARNING)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding.  ``path`` is repo-relative posix; ``line`` is
    1-indexed (0 for file- or artifact-scoped findings like a missing
    kernel triad file or a dropped donation)."""
    rule: str
    severity: str
    path: str
    line: int
    message: str

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def fingerprint(self) -> tuple:
        """Line-free identity used for baseline matching and dedup."""
        return (self.rule, self.path, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line,
                "message": self.message}

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.severity} [{self.rule}] {self.message}"


def sort_findings(findings) -> list:
    """Deterministic report order: by path, then line, then rule."""
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule,
                                           f.message))


class Baseline:
    """The suppression file: a JSON list of known findings with reasons.

    Format::

        {"version": 1,
         "suppressions": [
            {"rule": "...", "path": "...", "message": "...",
             "reason": "why this is accepted"}, ...]}

    ``message`` may be omitted to match any finding of (rule, path)."""

    def __init__(self, suppressions: list[dict] | None = None):
        self.suppressions = list(suppressions or [])
        for s in self.suppressions:
            if not s.get("reason"):
                raise ValueError(
                    f"baseline entry {s.get('rule')}/{s.get('path')} "
                    f"has no reason — suppressions must be justified")

    @classmethod
    def load(cls, path) -> "Baseline":
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return cls()
        return cls(data.get("suppressions", []))

    @classmethod
    def from_findings(cls, findings, reason: str) -> "Baseline":
        return cls([{"rule": f.rule, "path": f.path, "message": f.message,
                     "reason": reason} for f in sort_findings(findings)])

    def dump(self, path) -> None:
        with open(path, "w") as f:
            json.dump({"version": 1, "suppressions": self.suppressions},
                      f, indent=1)
            f.write("\n")

    def matches(self, finding: Finding) -> bool:
        for s in self.suppressions:
            if s.get("rule") != finding.rule:
                continue
            if s.get("path") != finding.path:
                continue
            if "message" in s and s["message"] != finding.message:
                continue
            return True
        return False

    def apply(self, findings) -> tuple[list, list]:
        """Split findings into (new, suppressed)."""
        new, suppressed = [], []
        for f in findings:
            (suppressed if self.matches(f) else new).append(f)
        return new, suppressed


def render_human(new, suppressed=()) -> str:
    lines = [f.render() for f in sort_findings(new)]
    n_err = sum(f.severity == SEVERITY_ERROR for f in new)
    n_warn = len(new) - n_err
    lines.append(f"{len(new)} new finding(s) "
                 f"({n_err} error, {n_warn} warning), "
                 f"{len(suppressed)} baselined")
    return "\n".join(lines)


def render_json(new, suppressed=()) -> str:
    new = sort_findings(new)
    payload = {
        "version": 1,
        "counts": {
            "new": len(new),
            "errors": sum(f.severity == SEVERITY_ERROR for f in new),
            "warnings": sum(f.severity == SEVERITY_WARNING for f in new),
            "baselined": len(suppressed),
        },
        "findings": [f.to_dict() for f in new],
        "baselined": [f.to_dict() for f in sort_findings(suppressed)],
    }
    return json.dumps(payload, indent=1)
