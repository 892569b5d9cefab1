"""Training across processes: the layout engine and the sharded update, the
redistribution primitive (a sharded tree moved between layouts over
processes: the elastic shrink and regrow, the KV handoff's transfer leg) and
LocalSGD."""

from .local_sgd import LocalSGD
from .redistribute import (
    EpochFence,
    RedistributeConfig,
    RedistributeError,
    RedistributePlan,
    RedistributeStageFailure,
    plan_redistribute,
    redistribute,
)
from .sharding import (
    PartitionRules,
    fold_update_spec,
    fsdp_auto_spec,
    infer_shardings,
    param_path,
    replicated,
    shard_tree,
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
    elastic_redundancy_bytes,
    zero_update_state_bytes,
)

__all__ = [
    "EpochFence",
    "LocalSGD",
    "PartitionRules",
    "RedistributeConfig",
    "RedistributeError",
    "RedistributePlan",
    "RedistributeStageFailure",
    "ShardedLayout",
    "build_zero_step",
    "fold_update_spec",
    "fsdp_auto_spec",
    "gather_full",
    "infer_shardings",
    "make_grad_reducer",
    "param_path",
    "plan_redistribute",
    "redistribute",
    "replicated",
    "shard_tree",
    "sharded_global_norm",
    "shardings_like",
    "tx_couples_across_leaves",
    "zero_batch_axes",
    "zero_ineligible_reason",
    "zero_update_shardings",
    "elastic_redundancy_bytes",
    "zero_update_state_bytes",
]
