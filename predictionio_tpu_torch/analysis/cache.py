"""Content-hash-keyed per-file findings cache for the port's ``lint``.

The rule set splits cleanly in two:

* **per-file checkers** (``clock``, ``device_sync``,
  ``threads``, ``races``, ``lifecycle`` — each marks itself
  ``PER_FILE = True``): a module's findings are a pure function of
  that module's text. These are cacheable — and they carry the
  expensive per-module models (the thread-root/lockset model alone is
  ~⅓ of a cold run);
* **cross-file checkers** (``locks``,
  ``sharding_spec``, ``telemetry``, ``wire_contract``): lock-order
  cycles, the mesh-axis, metric-name and
  wire-contract registries all depend on *other* files' content.
  Caching them per file would be unsound, so they run every time.

The engine skips the per-file checkers for every module whose entry is
present and re-runs them only on the misses. Soundness:

* the key is ``sha256(analyzer_salt + file content)`` — the salt
  hashes every ``predictionio_tpu_torch/analysis/**.py`` source plus the
  Python major.minor, so editing any checker (or this file) misses the
  whole cache; a content edit misses that file;
* entries store *raw* findings, before suppression comments are
  applied — the engine applies suppressions on every run, so a cached
  file whose only change is a suppression comment would miss anyway
  (content key), and suppression semantics stay in exactly one place;
* entries are JSON (never pickle) and written atomically (temp file +
  ``os.replace``); an unreadable or schema-mismatched entry is deleted
  and treated as a miss.

The cache directory defaults to ``$XDG_CACHE_HOME/pio-tpu-torch-lint``
(or ``~/.cache/pio-tpu-torch-lint``); ``lint --cache-dir`` overrides it
and ``--no-cache`` disables the cache. Entries untouched for 30 days
are pruned opportunistically.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

#: bump to invalidate every existing cache entry on a format change
_SCHEMA = 1

#: prune entries not read/written for this long (best effort)
_PRUNE_AGE_S = 30 * 24 * 3600.0

#: env vars that may change what the analyzer reports (reserved
#: PIO_LINT_* namespace for future knobs) — their values are part of
#: the cache key, so a finding set produced under one configuration
#: never replays under another
_LINT_ENV_PREFIX = "PIO_LINT_"

#: memoized per lint-env tuple (the analyzer sources cannot change
#: within a process, but the env can — tests flip it)
_salt_memo: dict[tuple, str] = {}


def _lint_env() -> tuple:
    return tuple(sorted(
        (k, v)
        for k, v in os.environ.items()
        if k.startswith(_LINT_ENV_PREFIX)
    ))


def default_cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "pio-tpu-torch-lint")


def analyzer_salt() -> str:
    """Digest of the analyzer itself: every ``.py`` under
    ``predictionio_tpu_torch/analysis`` plus the Python major.minor (an AST
    produced under 3.11 must not replay under 3.12, where the grammar
    differs — try/except*, new nodes), the lint-relevant ``PIO_LINT_*``
    env, and the cache schema. Editing any checker invalidates the
    whole cache."""
    env = _lint_env()
    cached = _salt_memo.get(env)
    if cached is not None:
        return cached
    pkg_root = os.path.dirname(os.path.abspath(__file__))
    sources: list[str] = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in filenames:
            if name.endswith(".py"):
                sources.append(os.path.join(dirpath, name))
    h = hashlib.sha256()
    h.update(
        f"pio-lint-cache/{_SCHEMA}|py{sys.version_info[0]}."
        f"{sys.version_info[1]}|".encode()
    )
    for key, value in env:
        h.update(f"{key}={value}".encode())
        h.update(b"\0")
    for path in sorted(sources):
        h.update(os.path.relpath(path, pkg_root).encode())
        h.update(b"\0")
        try:
            with open(path, "rb") as f:
                h.update(f.read())
        except OSError:
            # an unreadable analyzer file: salt on its name only —
            # worst case the cache over-invalidates, never under
            h.update(b"<unreadable>")
        h.update(b"\0")
    _salt_memo[env] = h.hexdigest()
    return _salt_memo[env]


def _finding_to_entry(f: Finding) -> dict:
    # path is NOT stored: the same content may live at another path on
    # load (it is re-homed to the requesting module's rel_path)
    return {
        "rule": f.rule,
        "line": f.line,
        "col": f.col,
        "message": f.message,
        "context": f.context,
        "source": f.source,
    }


def _finding_from_entry(d: dict, rel_path: str) -> Finding:
    return Finding(
        rule=d["rule"],
        path=rel_path,
        line=d["line"],
        col=d["col"],
        message=d["message"],
        context=d["context"],
        source=d["source"],
    )


class LintCache:
    """Per-file findings cache; counts hits/misses for the summary."""

    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        self.hits = 0
        self.misses = 0
        self._salt = analyzer_salt()
        self._usable = True
        try:
            os.makedirs(self.dir, exist_ok=True)
        except OSError:
            # an unwritable cache dir degrades to cache-off, silently:
            # the lint result must be identical either way
            self._usable = False

    def _entry_path(self, text: str) -> str:
        key = hashlib.sha256(
            (self._salt + "\0").encode() + text.encode()
        ).hexdigest()
        return os.path.join(self.dir, f"{key}.json")

    def load(
        self, mod: SourceModule, checkers: frozenset[str]
    ) -> dict[str, list[Finding]] | None:
        """Cached per-checker findings for this module's content,
        re-homed to its current path; None (counted as a miss) when
        absent, unreadable, or covering a different checker set."""
        if not self._usable:
            self.misses += 1
            return None
        entry = self._entry_path(mod.text)
        try:
            with open(entry, encoding="utf-8") as f:
                data = json.load(f)
            by_checker = {
                name: [
                    _finding_from_entry(d, mod.rel_path)
                    for d in entries
                ]
                for name, entries in data["byChecker"].items()
            }
        except FileNotFoundError:
            self.misses += 1
            return None
        except (OSError, ValueError, KeyError, TypeError):
            # corrupt / truncated / old schema: drop it, re-analyze
            try:
                os.unlink(entry)
            except OSError:
                pass
            self.misses += 1
            return None
        if frozenset(by_checker) != checkers:
            # the per-file checker set changed without an analyzer-
            # source change (should not happen — the salt covers it —
            # but a partial entry must never mask a checker)
            self.misses += 1
            return None
        self.hits += 1
        try:
            os.utime(entry)  # keep hot entries out of the pruner
        except OSError:
            pass
        return by_checker

    def store(
        self, mod: SourceModule, by_checker: dict[str, list[Finding]]
    ) -> None:
        """Write this module's per-checker findings under its content
        key. Best effort: a failed store must never fail the lint."""
        if not self._usable:
            return
        entry = self._entry_path(mod.text)
        payload = {
            "schema": _SCHEMA,
            "byChecker": {
                name: [_finding_to_entry(f) for f in findings]
                for name, findings in by_checker.items()
            },
        }
        try:
            fd, tmp = tempfile.mkstemp(
                dir=self.dir, prefix=".tmp-", suffix=".json"
            )
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(payload, f)
                os.replace(tmp, entry)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            pass

    def prune(self, now: float | None = None) -> None:
        """Drop entries untouched for 30 days (best effort)."""
        if not self._usable:
            return
        now = time.time() if now is None else now
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            p = os.path.join(self.dir, name)
            try:
                if now - os.stat(p).st_mtime > _PRUNE_AGE_S:
                    os.unlink(p)
            except OSError:
                continue

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hitRate": round(self.hits / total, 4) if total else 0.0,
        }
