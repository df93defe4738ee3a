"""Regex-rule partition engine: placements matched to tree paths.

Counterpart of ``predictionio_tpu/parallel/partition.py``. A **rule
table** is an ordered sequence of ``(regex, PartitionSpec)`` pairs
matched against each leaf's "/"-joined path in a tree of nested dicts,
lists and tuples (``slabs/0/idx``); one table describes the placement of
a whole staged geometry. Rules match first-wins with ``re.search``;
scalar leaves are never partitioned; a leaf no rule matches is a hard
error. :func:`validate_rules` checks every axis a table names against a
concrete mesh at staging time.

The JAX package's ``shard_map`` shim has no counterpart: the port's
per-device bodies are plain loops over the mesh positions.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ComputeContext,
    P,
    PartitionSpec,
    Sharding,
    ShardedTensor,
    default_devices,
    pad_to_multiple,
    record_padded_rows,
)

logger = logging.getLogger(__name__)

#: one partition-rule table: ordered (regex, PartitionSpec) pairs
Rules = Sequence[tuple[str, PartitionSpec]]

__all__ = [
    "ALS_REPLICATED_RULES", "ALS_SHARDED_RULES", "P", "PartitionSpec",
    "Rules", "als_partition_rules", "leaf_path_name",
    "match_partition_rule", "match_partition_rules", "mesh_from_topology",
    "shard_pytree", "stage_factor_matrix", "topology_mesh_shape",
    "tree_leaf_names", "validate_rules",
]


# --------------------------------------------------------------------------
# Trees and leaf naming
# --------------------------------------------------------------------------


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(
        x, PartitionSpec
    )


def _flatten(tree, path=()):
    """``[(path, leaf)]`` in the JAX package's flatten order: dict keys
    sorted, sequences by index; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], path + (key,))
        return out
    if _is_node(tree):
        out = []
        for i, item in enumerate(tree):
            out += _flatten(item, path + (i,))
        return out
    return [(path, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_node(node):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(tree)


def leaf_path_name(path: tuple) -> str:
    """"/"-joined name of a leaf path (``slabs/0/idx``)."""
    return "/".join(str(p) for p in path)


def tree_leaf_names(tree: Any) -> list[str]:
    """Every leaf's "/"-joined path name, in flatten order."""
    return [leaf_path_name(p) for p, _ in _flatten(tree)]


# --------------------------------------------------------------------------
# Rule matching
# --------------------------------------------------------------------------


def match_partition_rule(rules: Rules, name: str) -> PartitionSpec:
    """The spec the first matching rule assigns to ``name``; raises
    ``ValueError`` when none matches."""
    for pattern, spec in rules:
        if re.search(pattern, name) is not None:
            return spec
    raise ValueError(
        f"no partition rule matches leaf {name!r}; add a rule (or an "
        f"explicit catch-all) to the table"
    )


def _shape(leaf) -> tuple:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else np.shape(leaf)


def match_partition_rules(rules: Rules, tree: Any) -> Any:
    """Tree of specs matching ``tree``'s structure. Scalar leaves (0-d
    or single-element arrays, plain numbers) get ``P()`` without
    consulting the table."""
    specs = []
    for path, leaf in _flatten(tree):
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            specs.append(P())
        else:
            specs.append(match_partition_rule(rules, leaf_path_name(path)))
    return _unflatten(tree, specs)


def _spec_axes(spec: PartitionSpec):
    for entry in spec:
        if entry is None:
            continue
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        for axis in names:
            if axis is not None:
                yield axis


def validate_rules(rules: Rules, mesh) -> None:
    """Every axis a rule's spec names must exist on ``mesh``."""
    axes = set(getattr(mesh, "mesh", mesh).axis_names)
    for pattern, spec in rules:
        for axis in _spec_axes(spec):
            if axis not in axes:
                raise ValueError(
                    f"partition rule {pattern!r} names mesh axis "
                    f"{axis!r}, not on mesh axes {sorted(axes)}"
                )


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------


def shard_pytree(
    ctx_or_mesh, rules: Rules, tree: Any, *, validate: bool = True
) -> Any:
    """Commit every leaf of ``tree`` to the mesh per the rule table
    (match rules → validate axes → one placement per leaf). Accepts a
    :class:`ComputeContext` or a bare mesh."""
    mesh = getattr(ctx_or_mesh, "mesh", ctx_or_mesh)
    if validate:
        validate_rules(rules, mesh)
    leaves = []
    for path, leaf in _flatten(tree):
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            spec = P()
        else:
            spec = match_partition_rule(rules, leaf_path_name(path))
        leaves.append(Sharding(mesh, spec).place(leaf))
    return _unflatten(tree, leaves)


# --------------------------------------------------------------------------
# Mesh-from-topology helpers
# --------------------------------------------------------------------------


def topology_mesh_shape(
    n_devices: int, model_parallelism: int = 0
) -> tuple[int, int]:
    """(data, model) mesh shape for ``n_devices``: ``model_parallelism=0``
    picks a model axis of 2 whenever the count is even (and above 1),
    else 1; an explicit value must divide the count."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    model = model_parallelism or (
        2 if n_devices % 2 == 0 and n_devices > 1 else 1
    )
    if model < 1 or n_devices % model:
        raise ValueError(
            f"model_parallelism {model} does not divide {n_devices} "
            "devices"
        )
    return (n_devices // model, model)


def mesh_from_topology(
    n_devices: int | None = None,
    model_parallelism: int = 0,
    batch: str = "",
    devices: Sequence | None = None,
) -> ComputeContext:
    """ComputeContext over a (data, model) topology of the first
    ``n_devices`` devices (every visible card by default)."""
    devs = list(devices if devices is not None else default_devices())
    n = n_devices if n_devices is not None else len(devs)
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return ComputeContext.create(
        batch=batch,
        mesh_shape=topology_mesh_shape(n, model_parallelism),
        devices=devs[:n],
    )


# --------------------------------------------------------------------------
# ALS rule tables
# --------------------------------------------------------------------------

#: Model-sharded ALS geometry: factor matrices row-sliced over ``model``,
#: slab interaction arrays row-split over the combined (data, model)
#: axes so every device solves normal equations, the heavy-sub-row owner
#: map split with its slab, and the device-major reassembly permutation
#: split over ``model``.
ALS_SHARDED_RULES: Rules = (
    (r"(^|/)(user|item)_factors$", P(MODEL_AXIS, None)),
    (r"(^|/)owner$", P((DATA_AXIS, MODEL_AXIS))),
    (r"(^|/)(idx|weights|valid)$", P((DATA_AXIS, MODEL_AXIS), None)),
    (r"(^|/)inv_perm$", P(MODEL_AXIS)),
)

#: Replicated-factor ALS geometry: factor matrices replicated per
#: device, slab rows split over ``data`` only.
ALS_REPLICATED_RULES: Rules = (
    (r"(^|/)(user|item)_factors$", P()),
    (r"(^|/)(idx|weights|valid|owner)$", P(DATA_AXIS)),
    (r".*", P()),
)


def als_partition_rules(sharded: bool) -> Rules:
    """The ALS rule table for a factor layout."""
    return ALS_SHARDED_RULES if sharded else ALS_REPLICATED_RULES


# --------------------------------------------------------------------------
# Serving-side factor staging
# --------------------------------------------------------------------------


def _as_factor_tensor(arr) -> torch.Tensor:
    """A host factor matrix as a tensor. float64 becomes float32, as a
    device put does in the JAX package (64-bit types are off there)."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr)
    )
    if t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t


def stage_factor_matrix(
    ctx: ComputeContext,
    arr,
    n_real: int | None = None,
):
    """Commit one factor matrix row-sharded over ``model``; returns
    ``(factors, phantom_mask)``.

    Rows are padded with zeros to the model-axis multiple so each shard
    holds an equal slice. ``phantom_mask`` is True on rows past
    ``n_real`` (``None`` when there are none), split the same way;
    serving passes it to the top-k kernel as its ``[I]`` mask, so a
    padded row never surfaces as a result. With a model axis of 1 the
    factors are one tensor on ``ctx.device`` (the home of a replicated
    placement) and the mask one ``[rows]`` tensor; above 1 both are
    :class:`ShardedTensor`. A value already placed this way passes
    through without a copy; a device tensor must have a whole number of
    model-axis rows."""
    n_rows = int(arr.shape[0])
    n_real = n_rows if n_real is None else int(n_real)
    multiple = max(ctx.model_parallelism, 1)
    sharding = Sharding(
        ctx.mesh, match_partition_rule(ALS_SHARDED_RULES, "item_factors")
    )
    resident = isinstance(arr, ShardedTensor) or (
        isinstance(arr, torch.Tensor) and arr.device.type == ctx.device.type
    )
    if isinstance(arr, ShardedTensor) and multiple > 1 and (
        arr.sharding == sharding
    ):
        staged = arr
    elif resident:
        if n_rows % multiple:
            raise ValueError(
                f"device-resident factor matrix has {n_rows} rows, not "
                f"a multiple of model_parallelism {multiple}; pad at "
                "training time (train_als row_multiple does)"
            )
        t = _as_factor_tensor(
            arr.gather() if isinstance(arr, ShardedTensor) else arr)
        staged = (sharding.place(t) if multiple > 1
                  else t.to(ctx.device).contiguous())
    else:
        host = _as_factor_tensor(arr).cpu().numpy()
        padded = pad_to_multiple(host, multiple, axis=0)
        if padded.shape[0] != n_rows:
            record_padded_rows(padded.shape[0] - n_rows, n_rows, multiple)
        staged = (sharding.place(padded) if multiple > 1
                  else torch.as_tensor(padded).to(ctx.device).contiguous())
    if staged.shape[0] <= n_real:
        return staged, None
    mask = np.arange(staged.shape[0]) >= n_real
    if multiple > 1:
        return staged, Sharding(
            ctx.mesh, match_partition_rule(ALS_SHARDED_RULES, "inv_perm")
        ).place(mask)
    return staged, torch.as_tensor(mask).to(ctx.device)
