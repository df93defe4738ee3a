"""AST-based concurrency & device-discipline analyzer of the port
(``python -m predictionio_tpu_torch.cli.main lint``) — the JAX
package's linter with its rules, suppression syntax, baseline, scopes
and output formats. docs/static_analysis.md documents the 15 rules
carried unchanged; README.md's port section the two recast for torch
(device-sync-hot, sharding-spec) and the three not carried.

Public surface: :func:`run_lint`, :class:`LintResult`,
:class:`Finding`, the rule table ``RULES``, and the baseline helpers.
Everything in this package is stdlib-only (no torch, no numpy): the
gate runs in seconds on a bare checkout.
"""

from predictionio_tpu_torch.analysis.baseline import (
    BaselineEntry,
    BaselineError,
    load_baseline,
    render_baseline,
)
from predictionio_tpu_torch.analysis.engine import (
    LintResult,
    analyze_modules,
    run_lint,
)
from predictionio_tpu_torch.analysis.model import RULES, Finding, Rule
from predictionio_tpu_torch.analysis.sarif import render_sarif

__all__ = [
    "RULES",
    "BaselineEntry",
    "BaselineError",
    "Finding",
    "LintResult",
    "Rule",
    "analyze_modules",
    "load_baseline",
    "render_baseline",
    "render_sarif",
    "run_lint",
]
