"""Baseline file for the port's ``lint`` — the accepted pre-existing
finding set. The port's ships empty
(``predictionio_tpu_torch/analysis/lint_baseline.txt``).

Format (one finding per line, ``|``-separated; ``#`` comments and blank
lines ignored)::

    rule|path|context|line|source text

Matching ignores the recorded line number: a finding matches a baseline
entry when (rule, path, context, whitespace-normalized source) agree,
so edits elsewhere in the file don't resurrect baselined findings.
Matching is multiset-aware: two identical violations need two entries.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

from predictionio_tpu_torch.analysis.model import Finding, normalize


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    context: str
    line: int
    source: str
    raw_line_no: int  # line in the baseline file itself (diagnostics)

    def fingerprint(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.context, normalize(self.source))


class BaselineError(ValueError):
    pass


def load_baseline(path: str) -> list[BaselineEntry]:
    entries: list[BaselineEntry] = []
    with open(path, encoding="utf-8") as f:
        for i, raw in enumerate(f, start=1):
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            parts = line.split("|", 4)
            if len(parts) != 5:
                raise BaselineError(
                    f"{path}:{i}: expected "
                    f"'rule|path|context|line|source', got {line!r}"
                )
            rule, fpath, context, lineno, source = parts
            try:
                n = int(lineno)
            except ValueError:
                raise BaselineError(
                    f"{path}:{i}: line field {lineno!r} is not an int"
                ) from None
            entries.append(
                BaselineEntry(rule, fpath, context, n, source, i)
            )
    return entries


def render_baseline(findings: list[Finding]) -> str:
    header = (
        "# pio-tpu lint baseline — accepted pre-existing findings.\n"
        "# Regenerate with: pio-tpu lint --write-baseline\n"
        "# Format: rule|path|context|line|source "
        "(matching ignores the line number)\n"
    )
    rows = [
        f"{f.rule}|{f.path}|{f.context}|{f.line}|{f.source}"
        for f in sorted(findings, key=Finding.sort_key)
    ]
    return header + "".join(row + "\n" for row in rows)


def split_by_baseline(
    findings: list[Finding], entries: list[BaselineEntry]
) -> tuple[list[Finding], list[Finding], list[BaselineEntry]]:
    """(new, baselined, stale) — stale entries match no live finding
    and should be pruned from the baseline file."""
    budget = Counter(e.fingerprint() for e in entries)
    new: list[Finding] = []
    baselined: list[Finding] = []
    for f in sorted(findings, key=Finding.sort_key):
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            baselined.append(f)
        else:
            new.append(f)
    stale: list[BaselineEntry] = []
    for e in entries:
        fp = e.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            stale.append(e)
    return new, baselined, stale
