"""Finding + rule model for the port's ``lint`` static analyzer.

A Finding is one rule violation at one source location. Its
*fingerprint* deliberately excludes the line number: baselines match on
(rule, path, enclosing qualname, normalized source text) so that
unrelated edits above a baselined site don't resurrect it as "new".
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    hint: str


#: the rule catalog — docs/static_analysis.md documents each carried
#: rule with rationale and fix patterns, README.md's port section the
#: two recast for torch (device-sync-hot, sharding-spec) and the three
#: not carried (device-sync-jit, jit-retrace, donation: the port has no
#: torch.compile, torch.jit, CUDA graphs or buffer donation)
RULES: dict[str, Rule] = {
    r.id: r
    for r in (
        Rule(
            "lock-order",
            "lock-acquisition cycle (potential deadlock)",
            "acquire locks in one global order, or collapse them into "
            "a single lock",
        ),
        Rule(
            "lock-blocking",
            "blocking call while holding a lock",
            "move the blocking call outside the critical section: "
            "snapshot state under the lock, then block",
        ),
        Rule(
            "wall-clock",
            "wall clock (time.time) in duration/deadline arithmetic",
            "use time.monotonic() (or serving.resilience.Deadline); "
            "time.time() jumps under NTP steps and DST",
        ),
        Rule(
            "device-sync-hot",
            "host sync on the enqueue-only dispatch path",
            "batch_predict_launch/dispatch must only enqueue: return "
            "un-fetched device tensors and pay the barrier (.cpu(), "
            ".item(), synchronize) in collect()",
        ),
        Rule(
            "sharding-spec",
            "PartitionSpec names an axis no mesh defines",
            "PartitionSpec axes must name an axis of a Mesh(...) "
            "construction (parallel.mesh DATA_AXIS / MODEL_AXIS)",
        ),
        Rule(
            "shared-state-race",
            "field written on one thread root and accessed on another "
            "with no common lock",
            "guard every access with one lock, hand the value off "
            "through a Queue/Event, or publish immutable replacements "
            "(single store, single-load readers) instead of mutating "
            "shared state",
        ),
        Rule(
            "lock-consistency",
            "field guarded by one lock at most sites but bare or under "
            "a different lock elsewhere",
            "take the majority lock at the deviating sites (snapshot "
            "under the lock, then work on the copy) so every dangerous "
            "access agrees on the guard",
        ),
        Rule(
            "check-then-act",
            "decision reads a shared field, the update writes it, and "
            "the lock is released in between",
            "hold one lock across the check AND the act, or re-check "
            "the field under the lock at the write (compare-and-set) "
            "so an interposing thread cannot invalidate the decision",
        ),
        Rule(
            "wire-header",
            "X-PIO-* header contract broken (unpaired producer/"
            "consumer, or a near-miss spelling)",
            "set and read the header through one shared module "
            "constant (resilience.DEADLINE_HEADER style) so both "
            "sides of the wire agree on the exact name",
        ),
        Rule(
            "wire-route",
            "client request path matches no registered route",
            "register the route on the serving side, or fix the "
            "client path to match an existing Router.route pattern",
        ),
        Rule(
            "wire-metric",
            "metric scraped by name but never registered",
            "register the metric with registry.counter/gauge/"
            "histogram, or fix the scrape to an exported name — a "
            "scrape of an unregistered name can only read absent",
        ),
        Rule(
            "wire-env",
            "PIO_* env var read in code but absent from the docs env "
            "tables",
            "add the variable to the relevant docs/*.md env table "
            "(name, default, semantics) — undocumented knobs cannot "
            "be discovered by operators",
        ),
        Rule(
            "acquire-release",
            "paired acquire/release protocol not exception-safe",
            "pair every try_acquire/begin/inflight-increment with its "
            "release/end/decrement in a finally block so exception "
            "paths cannot leak the slot",
        ),
        Rule(
            "resource-leak",
            "OS resource (file/socket/process/tempdir) without "
            "guaranteed cleanup",
            "open resources in a with statement, close them in a "
            "finally, or hand ownership to a component that does",
        ),
        Rule(
            "thread-lifecycle",
            "thread neither daemonized nor joined",
            "pass daemon=True (documenting the shutdown contract) or "
            "join the thread from close()/stop()",
        ),
        Rule(
            "span-leak",
            "span opened outside a with-statement",
            "open spans with `with tracer.trace(...)`/`tracing.span(...)` "
            "so they close on every exit path",
        ),
        Rule(
            "metric-labels",
            "metric name registered with inconsistent label sets",
            "register each metric name with exactly one kind and one "
            "label tuple, project-wide",
        ),
    )
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    col: int
    message: str
    context: str  # enclosing qualname, "" at module scope
    source: str  # stripped text of the flagged source line

    @property
    def hint(self) -> str:
        return RULES[self.rule].hint

    def fingerprint(self) -> tuple[str, str, str, str]:
        return (self.rule, self.path, self.context, normalize(self.source))

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "context": self.context,
            "message": self.message,
            "hint": self.hint,
            "source": self.source,
        }

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        ctx = f" [{self.context}]" if self.context else ""
        return (
            f"{where}: {self.rule}{ctx}: {self.message}\n"
            f"    {self.source}\n"
            f"    fix: {self.hint}"
        )


def normalize(source_line: str) -> str:
    """Whitespace-insensitive form used for baseline matching."""
    return " ".join(source_line.split())
