"""Device-sync discipline on the dispatch hot path, for torch.

``device-sync-hot``: inside ``batch_predict_launch`` (and ``dispatch``
methods of two-phase batch_fn classes that also define ``collect``) the
contract is *enqueue-only*: the launch returns tensors the card is
still computing and the barrier belongs in ``collect``. A host sync
there serialises the micro-batcher's overlap of one batch's launch with
the previous batch's copy-out. Flagged:

* the explicit syncs on any receiver: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.to("cpu")`` / ``.to(device="cpu")``,
  ``torch.cuda.synchronize()`` and ``.synchronize()`` (a CUDA ``Event``
  or ``Stream``);
* ``float()`` / ``int()`` / ``bool()`` / ``np.asarray()`` /
  ``np.array()`` of a *tensor-tainted* value.

Taint is the JAX rule's value taint with other seeds: the launch's
parameters are the model handle and the host queries, so they start
clean, and host preparation on them (``int(q.get("num", 10))``,
``np.asarray(user_idx)``) stays legal. A value is tensor-tainted when
it comes from a ``torch.*`` call or a ``.to(...)`` / ``.cuda()``
transfer, or is assigned from a tainted value; shape reads
(``x.shape[0]``, ``len(x)``) are host constants and kill the taint.

The JAX package's second scope, ``device-sync-jit``, is not carried:
the port compiles nothing (no ``torch.compile``, ``torch.jit`` or CUDA
graphs), so there is no traced body to keep device-only.
"""

from __future__ import annotations

import ast

from predictionio_tpu_torch.analysis import astutil
from predictionio_tpu_torch.analysis.model import Finding
from predictionio_tpu_torch.analysis.source import SourceModule

_NP_SYNC = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SYNC_DOTTED = {"torch.cuda.synchronize", "cuda.synchronize"}
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_CASTS = {"float", "int", "bool"}
#: method calls whose result lives on the card
_TRANSFER_ATTRS = {"to", "cuda"}
#: attribute reads that are host constants even on a tensor
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}


def _is_hot_path(qual: str, index: astutil.FunctionIndex) -> bool:
    name = qual.rsplit(".", 1)[-1]
    if name == "batch_predict_launch":
        return True
    if name == "dispatch":
        owner = index.owner_class.get(qual, "")
        return "collect" in index.class_methods.get(owner, set())
    return False


def _is_cpu(expr: ast.AST) -> bool:
    """``"cpu"`` / ``torch.device("cpu")`` / ``"cpu:0"``."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":")[0] == "cpu"
    if isinstance(expr, ast.Call) and astutil.dotted_name(expr.func) in (
        "torch.device", "device"
    ):
        return bool(expr.args) and _is_cpu(expr.args[0])
    return False


def _to_cpu(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    return any(_is_cpu(a) for a in call.args) or any(
        kw.arg == "device" and _is_cpu(kw.value) for kw in call.keywords
    )


def _is_tensor_source(call: ast.Call) -> bool:
    name = astutil.dotted_name(call.func) or ""
    if name.startswith("torch."):
        return True
    return (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _TRANSFER_ATTRS
        and not _to_cpu(call)
    )


def expr_is_tainted(expr: ast.AST, tainted: set[str]) -> bool:
    """Can ``expr``'s value be a tensor on the card?"""
    if isinstance(expr, ast.Attribute) and expr.attr in _SHAPE_ATTRS:
        return False
    if isinstance(expr, ast.Call):
        if astutil.dotted_name(expr.func) == "len":
            return False
        if _is_tensor_source(expr):
            return True
        receiver = (
            (expr.func.value,)
            if isinstance(expr.func, ast.Attribute)
            else ()
        )
        return any(
            expr_is_tainted(c, tainted)
            for c in (
                *receiver,
                *expr.args,
                *(kw.value for kw in expr.keywords),
            )
        )
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(
        expr, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
               ast.ClassDef)
    ):
        return False
    return any(
        expr_is_tainted(c, tainted) for c in ast.iter_child_nodes(expr)
    )


def _target_names(target: ast.expr) -> list[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


def tainted_names(fn: ast.AST) -> set[str]:
    """Names that may hold a tensor on the card: anything assigned
    (``=``, walrus, for targets, comprehension variables) from a tainted
    expression, to a fixpoint. Parameters start clean."""
    tainted: set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            pairs: list[tuple[list[str], ast.AST]] = []
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if node.value is None:
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    pairs.append((_target_names(t), node.value))
            elif isinstance(node, ast.NamedExpr):
                pairs.append((_target_names(node.target), node.value))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                pairs.append((_target_names(node.target), node.iter))
            elif isinstance(node, ast.comprehension):
                pairs.append((_target_names(node.target), node.iter))
            for names, value in pairs:
                if not names or all(n in tainted for n in names):
                    continue
                if expr_is_tainted(value, tainted):
                    tainted.update(names)
                    changed = True
    return tainted


def _sync_desc(call: ast.Call, tainted: set[str]) -> str | None:
    dotted = astutil.dotted_name(call.func)
    if dotted in _SYNC_DOTTED:
        return f"{dotted}()"
    if isinstance(call.func, ast.Attribute) and (
        call.func.attr in _SYNC_ATTRS or _to_cpu(call)
    ):
        recv = astutil.dotted_name(call.func.value) or "<expr>"
        suffix = '("cpu")' if call.func.attr == "to" else "()"
        return f"{recv}.{call.func.attr}{suffix}"
    if (
        (dotted in _NP_SYNC or dotted in _HOST_CASTS)
        and call.args
        and expr_is_tainted(call.args[0], tainted)
    ):
        return f"{dotted}() on a tensor"
    return None


#: each module's findings depend only on that module's text --
#: cacheable per file (see analysis/cache.py)
PER_FILE = True


def check(modules: list[SourceModule]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        index = mod.index()
        for qual, fn in index.funcs.items():
            if not _is_hot_path(qual, index):
                continue
            tainted = tainted_names(fn)
            for call in astutil.calls_in(fn):
                desc = _sync_desc(call, tainted)
                if desc is None:
                    continue
                findings.append(
                    Finding(
                        rule="device-sync-hot",
                        path=mod.rel_path,
                        line=call.lineno,
                        col=call.col_offset,
                        message=(
                            f"implicit host sync {desc} inside "
                            f"enqueue-only dispatch path {qual}()"
                        ),
                        context=qual,
                        source=mod.source_line(call.lineno),
                    )
                )
    return findings
