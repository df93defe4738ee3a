"""Shared AST helpers for the lint checkers."""

from __future__ import annotations

import ast
from collections.abc import Iterator


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def attach_parents(tree: ast.AST) -> None:
    """Stamp ``_pio_parent`` on every node (lint-internal attribute)."""
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._pio_parent = parent  # type: ignore[attr-defined]


def parent_of(node: ast.AST) -> ast.AST | None:
    return getattr(node, "_pio_parent", None)


class FunctionIndex:
    """Qualname index over a module's functions and classes.

    ``funcs`` maps ``Class.method`` / ``func`` / ``outer.inner`` to the
    def node; ``owner_class`` maps the same keys to the enclosing class
    qualname (or ""). ``enclosing`` maps every AST node to the qualname
    of its innermost enclosing function ("" at module scope).
    """

    def __init__(self, tree: ast.AST):
        self.funcs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}
        self.owner_class: dict[str, str] = {}
        self.enclosing: dict[ast.AST, str] = {}
        self.class_methods: dict[str, set[str]] = {}
        self._walk(tree, class_stack=[], func_stack=[])

    def _qual(self, class_stack: list[str], func_stack: list[str],
              name: str) -> str:
        return ".".join([*class_stack, *func_stack, name])

    def _walk(self, node: ast.AST, class_stack: list[str],
              func_stack: list[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                self.class_methods.setdefault(
                    ".".join([*class_stack, child.name]), set()
                )
                self._mark(child, func_stack, class_stack)
                self._walk(
                    child, class_stack + [child.name], func_stack
                )
            elif isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                qual = self._qual(class_stack, func_stack, child.name)
                self.funcs[qual] = child
                self.owner_class[qual] = ".".join(class_stack)
                if class_stack and not func_stack:
                    self.class_methods.setdefault(
                        ".".join(class_stack), set()
                    ).add(child.name)
                self._mark_subtree(child, qual)
                self._walk(child, class_stack, func_stack + [child.name])
            else:
                self._mark(child, func_stack, class_stack)
                self._walk(child, class_stack, func_stack)

    def _mark(self, node: ast.AST, func_stack: list[str],
              class_stack: list[str]) -> None:
        if func_stack:
            self.enclosing[node] = ".".join([*class_stack, *func_stack])
        else:
            self.enclosing[node] = ""

    def _mark_subtree(self, node: ast.AST, qual: str) -> None:
        self.enclosing[node] = qual
        for sub in ast.walk(node):
            self.enclosing[sub] = qual

    def context_of(self, node: ast.AST) -> str:
        return self.enclosing.get(node, "")


def walk_statements(body: list[ast.stmt]) -> Iterator[ast.stmt]:
    """Depth-first statement walk that does NOT descend into nested
    function/class definitions (those have their own analyses)."""
    for stmt in body:
        yield stmt
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, field, None)
            if inner and not isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                yield from walk_statements(inner)
        for handler in getattr(stmt, "handlers", ()):
            yield from walk_statements(handler.body)
        for case in getattr(stmt, "cases", ()):  # ast.Match
            yield from walk_statements(case.body)


def calls_in(node: ast.AST) -> Iterator[ast.Call]:
    """Every Call beneath ``node``, skipping nested def/class bodies."""
    todo = list(ast.iter_child_nodes(node))
    while todo:
        cur = todo.pop()
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        if isinstance(cur, ast.Call):
            yield cur
        todo.extend(ast.iter_child_nodes(cur))
