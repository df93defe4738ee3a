"""sharding-spec — mesh-axis hygiene for the port's mesh.

The port's placements (``parallel/mesh.py``: ``PartitionSpec`` / ``P``,
``Sharding``, ``ShardedTensor``) name mesh axes by string. A spec naming
an axis no mesh has is silently treated as replicated, or raises deep
inside a placement with no source line. It is visible statically:

* a **project-wide axis registry** is built from every ``Mesh(...)``
  construction (its second argument or ``axis_names=``: tuples of
  string constants, resolved through module-level constants like
  ``DATA_AXIS = "data"``, parameter defaults — a default that is itself
  a tuple, as ``ComputeContext.create(axis_names=(DATA_AXIS,
  MODEL_AXIS))``, is flattened — and ``*_AXIS``-named string
  constants);
* every ``PartitionSpec(...)`` / ``P(...)`` site — ``P`` is recognised
  where a module binds it to ``PartitionSpec`` or imports either name
  from a ``mesh`` module, as ``parallel/partition.py``'s rule tables do
  — is checked against it: axis names that resolve to a string not on
  any mesh are flagged; unresolvable names are skipped (silence over
  guessing).

The JAX package's ``shard_map`` arity check and its sharding-less
``jax.device_put`` check have no counterpart: the port has neither.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

_MESH_CTORS = {"Mesh", "mesh.Mesh", "parallel.mesh.Mesh"}
_PSPEC_DOTTED = {"PartitionSpec", "mesh.PartitionSpec"}
_PSPEC_NAMES = {"PartitionSpec", "P"}


class _Registry:
    """Project-wide mesh axis names + per-module string constants."""

    def __init__(self, modules: list[SourceModule]):
        self.axes: set[str] = set()
        #: rel_path -> {name: str value} for module-level constants
        self.module_consts: dict[str, dict[str, str]] = {}
        #: bare name -> set of values across the project
        self.global_consts: dict[str, set[str]] = {}
        #: rel_path -> every name the module assigns anywhere; a name
        #: bound locally must never resolve through another module's
        #: same-named constant (silence over guessing)
        self.assigned_names: dict[str, set[str]] = {}
        for mod in modules:
            self._collect_consts(mod)
        for mod in modules:
            self._collect_meshes(mod)

    def _collect_consts(self, mod: SourceModule) -> None:
        index = mod.index()
        consts: dict[str, str] = {}
        assigned: set[str] = set()
        for node in mod.nodes():
            if isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Store
            ):
                assigned.add(node.id)
            if not isinstance(node, ast.Assign):
                continue
            if index.context_of(node) != "":
                continue
            if not (
                isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    consts[t.id] = node.value.value
                    self.global_consts.setdefault(t.id, set()).add(
                        node.value.value
                    )
                    if t.id.endswith("_AXIS") or t.id.startswith("AXIS_"):
                        self.axes.add(node.value.value)
        self.module_consts[mod.rel_path] = consts
        self.assigned_names[mod.rel_path] = assigned

    def _collect_meshes(self, mod: SourceModule) -> None:
        index = mod.index()
        for node in mod.nodes():
            if not isinstance(node, ast.Call):
                continue
            if astutil.dotted_name(node.func) not in _MESH_CTORS:
                continue
            axis_arg = None
            if len(node.args) >= 2:
                axis_arg = node.args[1]
            for kw in node.keywords:
                if kw.arg == "axis_names":
                    axis_arg = kw.value
            if axis_arg is not None:
                self._add_axes(mod, index, axis_arg, node)

    def _add_axes(self, mod, index, expr, site) -> None:
        for value in _iter_axis_exprs(expr):
            if isinstance(value, ast.Name):
                # `Mesh(grid, tuple(axis_names))` under a parameter
                # whose default is the tuple of axes
                default = _param_default(index, site, value.id)
                if isinstance(default, (ast.Tuple, ast.List)):
                    self._add_axes(mod, index, default, site)
                    continue
            resolved = self.resolve(mod, index, value, site)
            if resolved is not None:
                self.axes.add(resolved)

    def resolve(self, mod, index, expr, site) -> str | None:
        """String value of an axis expression, or None if unknowable."""
        if isinstance(expr, ast.Constant):
            return expr.value if isinstance(expr.value, str) else None
        if not isinstance(expr, ast.Name):
            return None
        consts = self.module_consts.get(mod.rel_path, {})
        if expr.id in consts:
            return consts[expr.id]
        default = _param_default(index, site, expr.id)
        if isinstance(default, ast.Constant) and isinstance(
            default.value, str
        ):
            return default.value
        # cross-module constant (`from mesh import MODEL_AXIS`): only
        # when this module never assigns the name itself — a local
        # `axis = pick_axis()` must stay unresolvable, not borrow an
        # unrelated module's same-named constant
        if expr.id not in self.assigned_names.get(mod.rel_path, set()):
            values = self.global_consts.get(expr.id, set())
            if len(values) == 1:
                return next(iter(values))
        return None


def _iter_axis_exprs(expr: ast.AST):
    """Flatten tuple/list/``tuple(...)`` wrappers into axis elements."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        for elt in expr.elts:
            yield from _iter_axis_exprs(elt)
    elif isinstance(expr, ast.Call) and astutil.dotted_name(
        expr.func
    ) in ("tuple", "list"):
        for a in expr.args:
            yield from _iter_axis_exprs(a)
    elif isinstance(expr, ast.Starred):
        yield from _iter_axis_exprs(expr.value)
    else:
        yield expr


def _scope_chain(ctx: str) -> list[str]:
    """``"a.b.c"`` -> ``["a.b.c", "a.b", "a", ""]``."""
    out = [ctx]
    while ctx:
        ctx = ctx.rsplit(".", 1)[0] if "." in ctx else ""
        out.append(ctx)
    return out


def _param_default(
    index: astutil.FunctionIndex, site: ast.AST, name: str
) -> ast.AST | None:
    """Default value of parameter ``name`` of the function enclosing
    ``site`` (walking outward), used to resolve the
    ``def create(axis_names=(DATA_AXIS, MODEL_AXIS))`` pattern."""
    for scope in _scope_chain(index.context_of(site)):
        fn = index.funcs.get(scope)
        if fn is None:
            continue
        args = fn.args
        pos = (*args.posonlyargs, *args.args)
        defaults = args.defaults
        offset = len(pos) - len(defaults)
        for i, a in enumerate(pos):
            if a.arg == name and i >= offset:
                return defaults[i - offset]
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if a.arg == name and d is not None:
                return d
    return None


def _pspec_aliases(mod: SourceModule) -> set[str]:
    """Names that construct a PartitionSpec in ``mod``: the class's own
    names, names imported from a ``mesh`` module, and module-level
    ``P = PartitionSpec`` bindings."""
    aliases = set(_PSPEC_DOTTED)
    for node in mod.nodes():
        if isinstance(node, ast.ImportFrom) and (
            node.module or ""
        ).rsplit(".", 1)[-1] == "mesh":
            for alias in node.names:
                if alias.name in _PSPEC_NAMES:
                    aliases.add(alias.asname or alias.name)
        elif (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Name)
            and node.value.id == "PartitionSpec"
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    aliases.add(t.id)
    return aliases


def check(modules: list[SourceModule]) -> list[Finding]:
    registry = _Registry(modules)
    findings: list[Finding] = []
    for mod in modules:
        index = mod.index()
        aliases = _pspec_aliases(mod)
        for node in mod.nodes():
            if isinstance(node, ast.Call) and (
                astutil.dotted_name(node.func) in aliases
            ):
                findings.extend(_check_pspec(mod, index, registry, node))
    return findings


def _check_pspec(
    mod: SourceModule,
    index: astutil.FunctionIndex,
    registry: _Registry,
    call: ast.Call,
) -> list[Finding]:
    if not registry.axes:
        return []  # no mesh anywhere — nothing to validate against
    findings = []
    for arg in call.args:
        if isinstance(arg, ast.Starred):
            continue
        for elt in _iter_axis_exprs(arg):
            if isinstance(elt, ast.Constant) and elt.value is None:
                continue
            resolved = registry.resolve(mod, index, elt, call)
            if resolved is None:
                continue
            if resolved not in registry.axes:
                known = ", ".join(sorted(registry.axes))
                findings.append(
                    Finding(
                        rule="sharding-spec",
                        path=mod.rel_path,
                        line=elt.lineno,
                        col=elt.col_offset,
                        message=(
                            f"PartitionSpec names axis {resolved!r} "
                            f"which no mesh defines (known axes: {known})"
                        ),
                        context=index.context_of(elt),
                        source=mod.source_line(elt.lineno),
                    )
                )
    return findings
