"""Shared-state race rules (docs/static_analysis.md "Concurrency
rules"): Eraser-style lockset analysis over the thread roots discovered
by :mod:`predictionio_tpu_torch.analysis.threads`.

Three rules, one model:

* ``shared-state-race`` — a ``self._x`` field written on one thread
  root and accessed dangerously on another with no lock common to all
  conflicting sites;
* ``lock-consistency`` — a field guarded by one lock at most dangerous
  sites but bare (or under a different lock) at others: names the
  majority lock and flags every deviating site;
* ``check-then-act`` — a read of ``self._x`` feeding a decision whose
  branch writes the same field, with the lock released between the two
  (two separate ``with`` blocks on the same lock count as released) —
  the reservation-vs-registration / verdict-CAS bug shape.

Exemptions — the idioms this codebase legitimately uses:

* **pre-start init**: accesses in ``__init__`` (and helpers reachable
  only from it) happen before any root thread exists;
* **GIL-atomic publication**: a field whose every write is a plain
  store of a fresh object and whose every read is a single load is
  safe under the GIL — but in-place mutation of the published object
  (``self._pub.append(...)``) or iteration during mutation is NOT, and
  re-enters the analysis;
* **single-writer read-modify-write**: ``self._n += 1`` confined to one
  (single-instance) root with all other roots doing single loads;
* **sync-typed fields**: ``Queue``/``Event``/``Condition``/
  ``Semaphore``/``ContextVar``/``threading.local`` fields mediate the
  handoff themselves.

Dangerous access = write / read-modify-write / in-place mutation /
iteration (dict & set iteration raises ``RuntimeError`` mid-mutation;
list iteration yields torn views). Plain single loads are GIL-atomic
and never conflict on their own.
"""

from __future__ import annotations

import ast
from collections import Counter

from predictionio_tpu_torch.analysis import astutil, threads
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

DANGEROUS = ("write", "rmw", "mutate", "iter")
WRITES = ("write", "rmw", "mutate")

#: each module's findings depend only on that module's text --
#: cacheable per file (see analysis/cache.py)
PER_FILE = True


def check(modules: list[SourceModule]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        model = threads.get_model(mod)
        if not model.roots:
            continue  # single-threaded module: no race analysis
        findings.extend(_check_fields(mod, model))
        findings.extend(_check_check_then_act(mod, model))
    return findings


# --------------------------------------------------------------------------
# shared-state-race + lock-consistency
# --------------------------------------------------------------------------


class _Site:
    """One access with its root attributions and effective locksets."""

    __slots__ = ("acc", "roots", "locks")

    def __init__(self, acc, roots, locks):
        self.acc = acc
        self.roots = roots  # list[int]
        self.locks = locks  # frozenset of lock ids


def _attributed_sites(model: threads.ThreadModel):
    """{(owner, field): [_Site]} for accesses that run on ≥1 root
    (init-only accesses have no roots and drop out here)."""
    out: dict[tuple[str, str], list[_Site]] = {}
    for qual, info in model.funcs.items():
        roots = model.roots_of(qual)
        if not roots:
            continue
        # entry lockset = intersection over every root that can reach
        # this function: only a lock held on ALL paths protects the
        # access
        entry: frozenset | None = None
        for r in roots:
            e = model.entry_locks(r, qual)
            entry = e if entry is None else entry & e
        for acc in info.accesses:
            locks = threads.tokens_to_locks(acc.held) | (
                entry or frozenset()
            )
            out.setdefault((acc.owner, acc.field), []).append(
                _Site(acc, roots, locks)
            )
    return out


def _effective_root_count(model, root_ids) -> int:
    return sum(2 if model.roots[r].multi else 1 for r in root_ids)


def _check_fields(
    mod: SourceModule, model: threads.ThreadModel
) -> list[Finding]:
    findings: list[Finding] = []
    for (owner, field), sites in sorted(_attributed_sites(model).items()):
        if (owner, field) in model.sync_fields:
            continue
        write_sites = [s for s in sites if s.acc.kind in WRITES]
        if not write_sites:
            continue
        all_roots = set()
        for s in sites:
            all_roots.update(s.roots)
        if _effective_root_count(model, all_roots) < 2:
            continue
        dangerous = [s for s in sites if s.acc.kind in DANGEROUS]
        common = None
        for s in dangerous:
            common = s.locks if common is None else (common & s.locks)
        if common:
            continue  # one lock consistently guards every dangerous site
        # GIL-atomic publication: plain stores + single loads only
        kinds = {s.acc.kind for s in sites}
        if kinds <= {"write", "read"}:
            continue
        # single-writer RMW with atomic readers: every dangerous access
        # confined to one single-instance root
        dangerous_roots = set()
        for s in dangerous:
            dangerous_roots.update(s.roots)
        if _effective_root_count(model, dangerous_roots) < 2:
            continue
        # classes driven only by external callers (route tables built
        # at setup, per-request objects, helpers their owner locks
        # around) are the caller's concurrency story — the rule fires
        # only when a DISCOVERED root (thread/handler/hook/callback)
        # touches the field dangerously
        if all(
            model.roots[r].kind == "external" for r in dangerous_roots
        ):
            continue
        majority = _majority_lock(dangerous)
        if majority is not None:
            lock, holders = majority
            for s in dangerous:
                if lock in s.locks:
                    continue
                state = (
                    f"under {_fmt_locks(s.locks)}"
                    if s.locks
                    else "with no lock"
                )
                findings.append(
                    Finding(
                        rule="lock-consistency",
                        path=mod.rel_path,
                        line=s.acc.line,
                        col=s.acc.col,
                        message=(
                            f"{_fq(owner, field)} is guarded by "
                            f"{lock} at {holders} site(s) but "
                            f"{_what(s.acc.kind)} {state} here "
                            f"(roots: {_root_names(model, s.roots)})"
                        ),
                        context=s.acc.qual,
                        source=mod.source_line(s.acc.line),
                    )
                )
            continue
        # no dominant lock at all: a plain race between named roots
        site = next(
            (s for s in dangerous if s.acc.kind in WRITES and not s.locks),
            dangerous[0],
        )
        other_roots = sorted(all_roots - set(site.roots)) or sorted(
            all_roots
        )
        findings.append(
            Finding(
                rule="shared-state-race",
                path=mod.rel_path,
                line=site.acc.line,
                col=site.acc.col,
                message=(
                    f"{_fq(owner, field)} is {_what(site.acc.kind)} on "
                    f"{_root_names(model, site.roots)} and accessed on "
                    f"{_root_names(model, other_roots)} with no common "
                    "lock"
                ),
                context=site.acc.qual,
                source=mod.source_line(site.acc.line),
            )
        )
    return findings


def _majority_lock(dangerous: list[_Site]) -> tuple[str, int] | None:
    """(lock, site count) when one lock guards ≥2 dangerous sites and
    at least half of them — the field has a de-facto guard and the
    stragglers are deviations, not a designed lock-free field."""
    counts: Counter = Counter()
    for s in dangerous:
        for lock in s.locks:
            counts[lock] += 1
    if not counts:
        return None
    lock, n = counts.most_common(1)[0]
    if n >= 2 and 2 * n >= len(dangerous):
        return lock, n
    return None


def _fq(owner: str, field: str) -> str:
    return f"{owner}.{field}" if owner else field


def _what(kind: str) -> str:
    return {
        "write": "written",
        "rmw": "read-modify-written",
        "mutate": "mutated in place",
        "iter": "iterated",
        "read": "read",
    }[kind]


def _fmt_locks(locks: frozenset) -> str:
    return "/".join(sorted(locks))


def _root_names(model: threads.ThreadModel, root_ids) -> str:
    names = sorted({model.roots[r].display for r in root_ids})
    return ", ".join(names) if names else "<no root>"


# --------------------------------------------------------------------------
# check-then-act
# --------------------------------------------------------------------------


def _check_check_then_act(
    mod: SourceModule, model: threads.ThreadModel
) -> list[Finding]:
    findings: list[Finding] = []
    # fields with ≥2 effective writer roots: only those can have a
    # second thread interpose between the check and the act
    writer_roots: dict[tuple[str, str], set[int]] = {}
    for qual, info in model.funcs.items():
        roots = model.roots_of(qual)
        if not roots:
            continue
        for acc in info.accesses:
            if acc.kind in WRITES:
                writer_roots.setdefault(
                    (acc.owner, acc.field), set()
                ).update(roots)
    contended = {
        key
        for key, roots in writer_roots.items()
        if _effective_root_count(model, roots) >= 2
        and any(model.roots[r].kind != "external" for r in roots)
        and key not in model.sync_fields
    }
    if not contended:
        return findings

    # one statement-lockset + field-test walk per function, shared by
    # the guarded-writes pass and the per-function scan below (each
    # used to rebuild the identical maps for every function)
    walks: dict[str, tuple[list, frozenset]] = {}
    for qual, fn in model.index.funcs.items():
        if model.funcs.get(qual) is None:
            continue
        held_at = _statement_locksets(model, qual, fn)
        walks[qual] = (
            list(_field_tests(model, qual, fn, held_at)),
            _entry_tokens(model, qual),
        )
    guarded = _self_guarded_writes(model, walks)
    for qual in model.index.funcs:
        if not model.roots_of(qual) or qual not in walks:
            continue
        owner = threads.owner_of(model.index, qual)
        findings.extend(
            _scan_cta(
                mod, model, qual, owner, contended, guarded,
                *walks[qual],
            )
        )
    return findings


def _self_guarded_writes(model, walks) -> set[tuple[str, int]]:
    """(qual, line) of writes that re-check their own field under a
    lock held continuously across the check and the write — the CAS /
    double-checked idiom. These are the FIX for check-then-act and must
    not be reported as acts of an outer, weaker check."""
    out: set[tuple[str, int]] = set()
    for qual, (tests, entry) in walks.items():
        info = model.funcs[qual]
        for test, test_held in tests:
            fields, extent = test
            for acc in info.accesses:
                if (
                    acc.kind in WRITES
                    and (acc.owner, acc.field) in fields
                    and extent[0] < acc.line <= extent[1]
                    and (acc.held | entry) & (test_held | entry)
                ):
                    out.add((qual, acc.line))
    return out


def _entry_tokens(model, qual) -> frozenset:
    """Locks provably held on EVERY entry to ``qual`` (over all its
    roots) as continuous pseudo-tokens — a function always called with
    the lock held runs its whole body inside one critical section."""
    roots = model.roots_of(qual)
    if not roots:
        return frozenset()
    locks = None
    for r in roots:
        entry = model.entry_locks(r, qual)
        locks = entry if locks is None else (locks & entry)
    return frozenset(f"{lid}@@entry" for lid in (locks or ()))


def _statement_locksets(model, qual, fn) -> dict[int, frozenset]:
    """{id(stmt): lock tokens held at that statement} — a re-walk of
    the same lexical ``with`` tracking the model's access scan used."""
    held_at: dict[int, frozenset] = {}

    def walk(body, held):
        for stmt in body:
            if isinstance(
                stmt,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue
            held_at[id(stmt)] = held
            inner = held
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    lid = model._resolve_lock(item.context_expr, qual)
                    if lid:
                        inner = inner | {model._with_token(lid, stmt)}
            for field in ("body", "orelse", "finalbody"):
                nested = getattr(stmt, field, None)
                if nested:
                    walk(nested, inner)
            for handler in getattr(stmt, "handlers", ()):
                walk(handler.body, inner)
            for case in getattr(stmt, "cases", ()):  # ast.Match
                walk(case.body, inner)

    walk(fn.body, frozenset())
    return held_at


def _field_tests(model, qual, fn, held_at):
    """Yield ((tested fields, (lineno, end_lineno)), held tokens at the
    read) for every If/While whose test reads a self-field — directly,
    or through a local alias assigned from one earlier in the
    function."""
    owner = threads.owner_of(model.index, qual)
    #: name -> (field key, held tokens at the aliasing read)
    aliases: dict[str, tuple[tuple[str, str], frozenset]] = {}
    for stmt in astutil.walk_statements(fn.body):
        held = held_at.get(id(stmt), frozenset())
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Attribute)
            and isinstance(stmt.value.value, ast.Name)
            and stmt.value.value.id in ("self", "cls")
        ):
            aliases[stmt.targets[0].id] = (
                (owner, stmt.value.attr), held,
            )
            continue
        if isinstance(stmt, ast.Assign) and all(
            isinstance(t, ast.Name) for t in stmt.targets
        ):
            for t in stmt.targets:
                aliases.pop(t.id, None)
        if not isinstance(stmt, (ast.If, ast.While)):
            continue
        end = getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno
        direct: set[tuple[str, str]] = set()
        via_alias: list[tuple[tuple[str, str], frozenset]] = []
        for node in ast.walk(stmt.test):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in ("self", "cls")
                and isinstance(node.ctx, ast.Load)
                and not isinstance(
                    astutil.parent_of(node), ast.Call
                )  # self._x() is a call, not a state read
            ):
                direct.add((owner, node.attr))
            elif isinstance(node, ast.Name) and node.id in aliases:
                via_alias.append(aliases[node.id])
        if direct:
            yield (direct, (stmt.lineno, end)), held
        for key, alias_held in via_alias:
            yield ({key}, (stmt.lineno, end)), alias_held


def _scan_cta(mod, model, qual, owner, contended, guarded, tests, entry):
    findings = []
    info = model.funcs[qual]
    seen: set[tuple] = set()
    for (fields, extent), raw_test_held in tests:
        test_held = raw_test_held | entry
        keys = {k for k in fields if k in contended}
        if not keys:
            continue
        # direct writes inside the decision's branches
        for acc in info.accesses:
            if (
                acc.kind in WRITES
                and (acc.owner, acc.field) in keys
                and extent[0] < acc.line <= extent[1]
                and not ((acc.held | entry) & test_held)
                and (qual, acc.line) not in guarded
            ):
                findings.append(
                    _cta_finding(
                        mod, qual, acc.owner, acc.field,
                        extent[0], acc.line, acc.col, test_held,
                        mod.source_line(acc.line),
                    )
                )
                seen.add((acc.owner, acc.field, extent[0]))
        # writes through a same-module helper called in the branches
        for callee, call_held, line in info.calls:
            if not (extent[0] < line <= extent[1]):
                continue
            callee_info = model.funcs.get(callee)
            if callee_info is None:
                continue
            for key in keys:
                w = next(
                    (
                        a
                        for a in callee_info.accesses
                        if a.kind in WRITES
                        and (a.owner, a.field) == key
                    ),
                    None,
                )
                if w is None or (key[0], key[1], extent[0]) in seen:
                    continue
                if (callee, w.line) in guarded:
                    continue
                act_held = call_held | w.held | entry
                if act_held & test_held:
                    continue
                findings.append(
                    _cta_finding(
                        mod, qual, key[0], key[1], extent[0], line, 0,
                        test_held, mod.source_line(line),
                        via=callee,
                    )
                )
                seen.add((key[0], key[1], extent[0]))
    return findings


def _cta_finding(
    mod, qual, owner, field, test_line, act_line, col, test_held,
    source, via: str | None = None,
):
    read_state = (
        f"read under {_fmt_locks(threads.tokens_to_locks(test_held))} "
        "(released before the update)"
        if test_held
        else "read with no lock"
    )
    through = f" through {via}()" if via else ""
    return Finding(
        rule="check-then-act",
        path=mod.rel_path,
        line=act_line,
        col=col,
        message=(
            f"{_fq(owner, field)} checked at line {test_line} "
            f"({read_state}) then written{through} — another thread "
            "can interpose between the check and the act"
        ),
        context=qual,
        source=source,
    )
