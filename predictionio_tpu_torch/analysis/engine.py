"""Driver for the port's ``lint``: load sources, run every checker,
apply suppressions, split against the baseline.

Deliberately torch-free and stdlib-only: the lint gate must run in
seconds on any checkout (CI sets it up before the heavyweight test
deps), and importing an accelerator runtime to parse python would be
absurd.

Each checker's wall time is recorded (``LintResult.timings_ms``,
surfaced as ``timingsMs`` under ``--json``) so the growing rule set
can't silently bloat the gate — ``tests/test_torch_lint_tree.py`` holds the
whole surface to a 30 s budget.

``changed_ref`` scopes *reporting* to files touched vs a git ref
(``lint --changed``) — more precisely vs ``git merge-base REF
HEAD``, so a feature branch's ``--changed main`` never pulls in files
main changed since the branch point. The full tree is still loaded and
analyzed so project-wide rules (lock cycles, metric-name registry,
mesh-axis registry, the wire-contract registries) keep their context,
but findings are only reported in changed files. When git is unavailable the scope silently widens
back to the full tree — the fast path must never be less strict than
the slow one.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time

from predictionio_tpu_torch.analysis import baseline as baseline_mod
from predictionio_tpu_torch.analysis.checkers import (
    ALL_CHECKERS,
    PER_FILE_CHECKERS,
)
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import (
    SourceModule,
    iter_python_files,
    load_modules,
)


@dataclasses.dataclass
class LintResult:
    new: list[Finding]
    baselined: list[Finding]
    stale_baseline: list[baseline_mod.BaselineEntry]
    errors: list[str]
    files_checked: int
    #: checker module name -> wall milliseconds
    timings_ms: dict[str, float] = dataclasses.field(default_factory=dict)
    total_ms: float = 0.0
    #: repo-relative changed files reporting was scoped to
    #: (None = full-tree run)
    scoped_to: list[str] | None = None
    notes: list[str] = dataclasses.field(default_factory=list)
    #: {"hits": n, "misses": m, "hitRate": 0.xx} when the parse/index
    #: cache was enabled (None = cache off)
    cache: dict | None = None

    @property
    def ok(self) -> bool:
        return not self.new and not self.errors

    def all_findings(self) -> list[Finding]:
        return sorted(self.new + self.baselined, key=Finding.sort_key)


def analyze_modules(
    modules: list[SourceModule],
    timings_ms: dict[str, float] | None = None,
    cache=None,
) -> list[Finding]:
    """Run every checker, drop suppressed findings. When ``timings_ms``
    is given, each checker's wall time lands in it keyed by module
    name (``locks``, ``jit_retrace``, ...).

    With a :class:`predictionio_tpu_torch.analysis.cache.LintCache`, modules
    whose content already has an entry skip the per-file checkers
    (their cached findings are replayed instead — raw, so suppression
    comments are still applied fresh below); cross-file checkers run
    on the full module list every time."""
    by_path = {m.rel_path: m for m in modules}
    cached: dict[str, dict[str, list[Finding]]] = {}
    fresh: dict[str, dict[str, list[Finding]]] = {}
    if cache is not None:
        for m in modules:
            entry = cache.load(m, PER_FILE_CHECKERS)
            if entry is not None:
                cached[m.rel_path] = entry
    findings: list[Finding] = []
    for checker in ALL_CHECKERS:
        name = checker.__module__.rsplit(".", 1)[-1]
        start = time.monotonic()
        if cache is not None and name in PER_FILE_CHECKERS:
            miss_mods = [
                m for m in modules if m.rel_path not in cached
            ]
            checker_findings = checker(miss_mods) if miss_mods else []
            grouped: dict[str, list[Finding]] = {}
            for f in checker_findings:
                grouped.setdefault(f.path, []).append(f)
            for m in miss_mods:
                fresh.setdefault(m.rel_path, {})[name] = grouped.get(
                    m.rel_path, []
                )
            checker_findings = list(checker_findings)
            for entry in cached.values():
                checker_findings.extend(entry.get(name, []))
        else:
            checker_findings = checker(modules)
        if timings_ms is not None:
            timings_ms[name] = round(
                timings_ms.get(name, 0.0)
                + (time.monotonic() - start) * 1000.0,
                2,
            )
        for f in checker_findings:
            mod = by_path.get(f.path)
            if mod is not None and mod.suppressed(f.rule, f.line):
                continue
            findings.append(f)
    if cache is not None:
        for rel_path, by_checker in fresh.items():
            # a module only reaches `fresh` via the miss list, where
            # every per-file checker ran on it — the entry is complete
            cache.store(by_path[rel_path], by_checker)
    return sorted(findings, key=Finding.sort_key)


class _BadRefError(Exception):
    """``--changed REF`` named something git cannot resolve to a
    commit — a typo'd branch or (classically) a path swallowed by the
    optional REF argument. Loud failure, never a silent wrong scope."""


def _git_changed_files(root: str, ref: str) -> tuple[set[str] | None, str]:
    """Root-relative changed + untracked files vs ``ref``; (None,
    reason) when git itself is unavailable (not a repo, no binary).
    An unresolvable ref raises :class:`_BadRefError` instead — git
    *is* available, so widening the scope would mask a user error
    (``git diff <dir>`` happily treats the bad ref as a pathspec).
    """
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
        if top.returncode != 0:
            return None, top.stderr.strip() or "not a git repository"
        git_root = top.stdout.strip()
        verify = subprocess.run(
            ["git", "rev-parse", "--verify", "--quiet",
             f"{ref}^{{commit}}"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
        if verify.returncode != 0:
            raise _BadRefError(
                f"--changed: {ref!r} does not name a commit "
                "(note: `--changed <path>` parses the path as the REF "
                "— put paths before the flag or use `--changed HEAD`)"
            )
        # diff against merge-base(REF, HEAD), not REF itself: on a
        # feature branch, `--changed main` must scope to what the
        # BRANCH changed — diffing against main directly would also
        # pull in every file main changed since the branch point
        # (files this checkout never touched). When REF is an
        # ancestor of HEAD the merge-base IS REF, so linear history
        # behaves exactly as before; no common ancestor (orphan
        # branches) falls back to REF.
        base = ref
        merge_base = subprocess.run(
            ["git", "merge-base", ref, "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
        if merge_base.returncode == 0 and merge_base.stdout.strip():
            base = merge_base.stdout.strip()
        # --name-status --find-renames, not --name-only: a renamed
        # file must enter scope under its NEW path (an `R` line), and
        # the OLD path must stay out of the changed set so it can't
        # match any report. Plain --name-only leaves rename handling
        # to the user's diff.renames config — scope would then depend
        # on local git configuration.
        diff = subprocess.run(
            ["git", "diff", "--name-status", "--find-renames", base],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
        if diff.returncode != 0:
            return None, diff.stderr.strip() or f"git diff {base} failed"
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return None, str(e)
    rel: set[str] = set()

    def add(base: str, name: str) -> None:
        abs_path = os.path.join(base, name)
        rel.add(os.path.relpath(abs_path, root).replace(os.sep, "/"))

    # name-status lines are `M\tpath` / `A\tpath` / `D\tpath` /
    # `R<score>\told\tnew` / `C<score>\told\tnew`; paths are
    # repo-root-relative. Deleted files and rename sources are
    # excluded: nothing at those paths exists to report against.
    for ln in diff.stdout.splitlines():
        parts = ln.rstrip("\n").split("\t")
        if len(parts) < 2 or not parts[0]:
            continue
        status = parts[0][0]
        if status == "D":
            continue
        add(git_root, parts[-1])  # R/C: the LAST path is the new one
    # `ls-files --others` prints paths relative to the cwd it ran in
    if untracked.returncode == 0:
        for ln in untracked.stdout.splitlines():
            name = ln.strip()
            if name:
                add(root, name)
    return rel, ""


def run_lint(
    paths: list[str],
    root: str | None = None,
    baseline_path: str | None = None,
    changed_ref: str | None = None,
    cache_dir: str | None = None,
    scope_paths: list[str] | None = None,
) -> LintResult:
    """``scope_paths`` filters *reporting* to files under those paths
    while ``paths`` is the full analysis surface — the same
    load-everything/report-a-slice split ``changed_ref`` uses. The CLI
    passes it when the user names explicit paths inside a project
    whose default surface exists: cross-file rules (wire-contract
    pairing, lock graphs, metric registries) would otherwise see only
    half the wire and cry wolf about the missing half."""
    root = os.path.abspath(root or os.getcwd())
    start = time.monotonic()
    cache = None
    if cache_dir is not None:
        from predictionio_tpu_torch.analysis.cache import LintCache

        cache = LintCache(cache_dir)
    files = iter_python_files(paths)
    modules, errors = load_modules(files, root)
    timings: dict[str, float] = {}
    findings = analyze_modules(modules, timings_ms=timings, cache=cache)
    if cache is not None:
        cache.prune()

    notes: list[str] = []
    scoped_to: list[str] | None = None
    if scope_paths is not None:
        in_scope = {
            os.path.relpath(f, root).replace(os.sep, "/")
            for f in iter_python_files(scope_paths)
        }
        scoped_to = sorted(
            in_scope & {m.rel_path for m in modules}
        )
        findings = [f for f in findings if f.path in in_scope]
        errors = [
            e for e in errors if e.split(":", 1)[0] in in_scope
        ]
    if changed_ref is not None:
        try:
            changed, reason = _git_changed_files(root, changed_ref)
        except _BadRefError as e:
            # git answered but the ref is garbage: fail loudly — a
            # silent full-tree (or worse, wrong-scope) run would mask
            # the user error
            errors.append(str(e))
            changed, reason = None, None
        if changed is None:
            if reason is not None:
                notes.append(
                    f"--changed: {reason}; falling back to the "
                    "full tree"
                )
        else:
            visible = changed & {m.rel_path for m in modules}
            if scoped_to is not None:
                visible &= set(scoped_to)
            scoped_to = sorted(visible)
            findings = [f for f in findings if f.path in changed]
            errors = [
                e for e in errors
                if e.split(":", 1)[0] in changed
            ]

    entries: list[baseline_mod.BaselineEntry] = []
    if baseline_path and os.path.exists(baseline_path):
        try:
            entries = baseline_mod.load_baseline(baseline_path)
        except baseline_mod.BaselineError as e:
            errors.append(str(e))
    new, baselined, stale = baseline_mod.split_by_baseline(
        findings, entries
    )
    if scoped_to is not None:
        # a scoped run sees only a slice of the findings — baseline
        # entries matching nothing here are NOT stale, just out of view
        stale = []
    return LintResult(
        new=new,
        baselined=baselined,
        stale_baseline=stale,
        errors=errors,
        files_checked=len(modules),
        timings_ms=timings,
        total_ms=round((time.monotonic() - start) * 1000.0, 2),
        scoped_to=scoped_to,
        notes=notes,
        cache=cache.stats() if cache is not None else None,
    )
