"""Training across processes: the layout engine and the sharded update, and
the KV handoff's transfer leg of the redistribution primitive."""

from .redistribute import RedistributeStageFailure
from .sharding import (
    PartitionRules,
    fold_update_spec,
    fsdp_auto_spec,
    infer_shardings,
    shardings_like,
    zero_batch_axes,
    zero_update_shardings,
)
from .zero import (
    ShardedLayout,
    build_zero_step,
    gather_full,
    make_grad_reducer,
    sharded_global_norm,
    tx_couples_across_leaves,
    zero_ineligible_reason,
    zero_update_state_bytes,
)

__all__ = [
    "PartitionRules",
    "RedistributeStageFailure",
    "ShardedLayout",
    "build_zero_step",
    "fold_update_spec",
    "fsdp_auto_spec",
    "gather_full",
    "infer_shardings",
    "make_grad_reducer",
    "sharded_global_norm",
    "shardings_like",
    "tx_couples_across_leaves",
    "zero_batch_axes",
    "zero_ineligible_reason",
    "zero_update_shardings",
    "zero_update_state_bytes",
]
