"""SARIF 2.1.0 renderer for the port's ``lint --format sarif``.

One ``run`` with the full rule catalog as ``tool.driver.rules`` (rule
metadata + fix hint as the rule's help text) and one ``result`` per NEW
finding. CI uploads the file with ``github/codeql-action/upload-sarif``
so findings land in the repository's Security → Code scanning tab,
alongside the inline ``--format github`` annotations.

``partialFingerprints`` carries the same line-number-free fingerprint
the baseline uses (rule | path | enclosing qualname | normalized source
line), so code-scanning alert identity survives unrelated edits above
a finding — exactly the property the baseline format was designed for.

Unanalyzable files are reported as tool ``notifications`` with level
``error`` (they fail the gate but have no rule or precise location).
"""

from __future__ import annotations

import json

from predictionio_tpu_torch.analysis.model import RULES, Finding


def _rule_ids() -> list[str]:
    return list(RULES)


def _sarif_rules() -> list[dict]:
    out = []
    for rule in RULES.values():
        out.append(
            {
                "id": rule.id,
                "name": rule.id.replace("-", " ").title().replace(" ", ""),
                "shortDescription": {"text": rule.summary},
                "fullDescription": {"text": rule.summary},
                "help": {
                    "text": (
                        f"fix: {rule.hint} "
                        "(rationale + examples: docs/static_analysis.md)"
                    )
                },
                "defaultConfiguration": {"level": "error"},
            }
        )
    return out


def _sarif_result(
    f: Finding, rule_index: dict[str, int], context_unique: bool
) -> dict:
    fp_rule, fp_path, fp_ctx, fp_src = f.fingerprint()
    fingerprints = {
        "pioLint/v1": f"{fp_rule}|{fp_path}|{fp_ctx}|{fp_src}",
    }
    if context_unique:
        # path-free identity: survives a file RENAME on top of the
        # line-number freedom above (code scanning matches alerts on
        # any shared fingerprint key, so a rename plus edits above the
        # site keeps the alert instead of closing and reopening it
        # under a new identity). Omitted when two findings in
        # DIFFERENT files share the triple (copy-paste twins): a
        # shared key would conflate two distinct alerts, and fixing
        # one would silently close the other.
        fingerprints["pioLint/contextV1"] = (
            f"{fp_rule}|{fp_ctx}|{fp_src}"
        )
    return {
        "ruleId": f.rule,
        "ruleIndex": rule_index[f.rule],
        "level": "error",
        "message": {"text": f"{f.message} — fix: {f.hint}"},
        "locations": [
            {
                "physicalLocation": {
                    # repo-relative URI with no uriBaseId: the upload
                    # action resolves it against the checkout root
                    "artifactLocation": {"uri": f.path},
                    "region": {
                        "startLine": f.line,
                        # SARIF columns are 1-based; Finding.col is 0-based
                        "startColumn": f.col + 1,
                        "snippet": {"text": f.source},
                    },
                },
                "logicalLocations": (
                    [{"fullyQualifiedName": f.context, "kind": "function"}]
                    if f.context
                    else []
                ),
            }
        ],
        "partialFingerprints": fingerprints,
    }


def render_sarif(result, tool_version: str) -> str:
    """SARIF 2.1.0 JSON for a :class:`LintResult` (new findings only:
    the shipped baseline is empty by policy, and a baselined finding is
    accepted debt, not an alert)."""
    rule_index = {rid: i for i, rid in enumerate(_rule_ids())}
    triple_counts: dict[tuple, int] = {}
    for f in result.new:
        fp_rule, _p, fp_ctx, fp_src = f.fingerprint()
        key = (fp_rule, fp_ctx, fp_src)
        triple_counts[key] = triple_counts.get(key, 0) + 1
    notifications = [
        {
            "level": "error",
            "message": {"text": err},
            "descriptor": {"id": "pio-lint/unanalyzable"},
        }
        for err in result.errors
    ]
    run = {
        "tool": {
            "driver": {
                "name": "pio-tpu-torch-lint",
                "version": tool_version,
                "semanticVersion": tool_version,
                "rules": _sarif_rules(),
            }
        },
        "columnKind": "utf16CodeUnits",
        "results": [
            _sarif_result(
                f,
                rule_index,
                context_unique=triple_counts[
                    (f.fingerprint()[0],) + f.fingerprint()[2:]
                ] == 1,
            )
            for f in result.new
        ],
        "invocations": [
            {
                "executionSuccessful": not result.errors,
                "toolExecutionNotifications": notifications,
            }
        ],
    }
    doc = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [run],
    }
    return json.dumps(doc, indent=2, sort_keys=False)
