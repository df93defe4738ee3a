"""Parallel substrate: the device mesh, placement rules, multi-process.

Counterpart of ``predictionio_tpu/parallel``: a :class:`ComputeContext`
over a (data, model) mesh of ``torch.device``, :class:`ShardedTensor`
placements from regex rule tables, and ``torch.distributed`` across
processes (``parallel.distributed``).
"""

from predictionio_tpu_torch.parallel.mesh import (
    ComputeContext,
    DATA_AXIS,
    MODEL_AXIS,
    ShardedTensor,
    assert_phantom_rows_zero,
    pad_to_multiple,
    sum_over_data,
)
from predictionio_tpu_torch.parallel.partition import (
    als_partition_rules,
    match_partition_rule,
    match_partition_rules,
    mesh_from_topology,
    shard_pytree,
    stage_factor_matrix,
    topology_mesh_shape,
    validate_rules,
)

__all__ = [
    "ComputeContext",
    "DATA_AXIS",
    "MODEL_AXIS",
    "ShardedTensor",
    "sum_over_data",
    "assert_phantom_rows_zero",
    "pad_to_multiple",
    "als_partition_rules",
    "match_partition_rule",
    "match_partition_rules",
    "mesh_from_topology",
    "shard_pytree",
    "stage_factor_matrix",
    "topology_mesh_shape",
    "validate_rules",
]
