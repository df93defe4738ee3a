"""Source loading + suppression comments for the port's ``lint``.

Suppression syntax (mirrors the known-failures convention: visible,
greppable, and carrying a reason):

    x = time.time()  # pio-lint: disable=wall-clock -- epoch for display
    # pio-lint: disable-next=span-leak -- retrospective span, see docs
    # pio-lint: disable-file=lock-blocking -- single-threaded script

``disable=`` covers its own physical line, ``disable-next=`` the line
below, ``disable-file=`` the whole file. Rule lists are comma-separated;
``all`` matches every rule. Comments are found with ``tokenize`` so a
string literal containing the marker can never suppress anything. The
syntax is the JAX package's, so both linters read the same comments.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize


_MARKER = re.compile(
    r"#\s*pio-lint:\s*(disable(?:-next|-file)?)\s*=\s*"
    r"([\w*][\w\-*]*(?:\s*,\s*[\w*][\w\-*]*)*)"
)


class SourceModule:
    """One parsed python file plus its suppression table."""

    def __init__(self, path: str, rel_path: str, text: str):
        self.path = path
        self.rel_path = rel_path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        #: line number -> set of suppressed rule ids ("*" = all)
        self.line_suppressions: dict[int, set[str]] = {}
        self.file_suppressions: set[str] = set()
        self._index = None
        self._nodes = None
        self._parse_suppressions()

    def index(self):
        """Parent-stamped :class:`astutil.FunctionIndex` for this tree,
        built once and shared by every checker (8 checkers × N files
        would otherwise re-walk each AST eight times)."""
        if self._index is None:
            from predictionio_tpu_torch.analysis import astutil

            astutil.attach_parents(self.tree)
            self._index = astutil.FunctionIndex(self.tree)
        return self._index

    def nodes(self) -> list:
        """Every node of the tree in ``ast.walk`` order, listed once and
        shared by the checkers (a dozen whole-tree walks a run would
        otherwise each re-walk every file)."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def _parse_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _MARKER.search(tok.string)
                if not m:
                    continue
                kind, raw_rules = m.groups()
                rules = {
                    ("*" if r.strip() in ("all", "*") else r.strip())
                    for r in raw_rules.split(",")
                    if r.strip()
                }
                if kind == "disable-file":
                    self.file_suppressions |= rules
                else:
                    line = tok.start[0] + (1 if kind == "disable-next" else 0)
                    self.line_suppressions.setdefault(line, set()).update(
                        rules
                    )
        except tokenize.TokenError:
            # a file ast could parse but tokenize trips on is rare;
            # losing its suppressions only makes the lint stricter
            pass

    def suppressed(self, rule: str, line: int) -> bool:
        if {"*", rule} & self.file_suppressions:
            return True
        at_line = self.line_suppressions.get(line, ())
        return "*" in at_line or rule in at_line

    def source_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


def iter_python_files(paths: list[str]) -> list[str]:
    """Expand files/directories into a sorted list of .py files,
    skipping caches and hidden directories."""
    out: set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            out.add(os.path.abspath(p))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [
                d
                for d in dirnames
                if not d.startswith(".") and d != "__pycache__"
            ]
            for name in filenames:
                if name.endswith(".py"):
                    out.add(os.path.abspath(os.path.join(dirpath, name)))
    return sorted(out)


def load_modules(
    files: list[str], root: str
) -> tuple[list[SourceModule], list[str]]:
    """Parse files; returns (modules, error strings). A file that does
    not parse is an error line, not a crash — the gate should report it
    alongside findings."""
    modules, errors = [], []
    root = os.path.abspath(root)
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
            modules.append(SourceModule(path, rel, text))
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{rel}: cannot analyze: {e}")
    return modules, errors
