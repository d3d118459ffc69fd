from .columns import ColumnShards, gather_tree
from .mesh import (
    Mesh,
    make_mesh,
    param_sharding_rules,
    shard_batch,
    shard_opt_state,
    shard_params,
    shard_training_state,
)
from .shard_map_step import fold_in, make_shard_map_train_step, replicate

__all__ = [
    "make_mesh",
    "shard_training_state",
    "param_sharding_rules",
    "shard_batch",
    "shard_params",
    "make_shard_map_train_step",
    "replicate",
    "Mesh",
    "fold_in",
    "shard_opt_state",
    "ColumnShards",
    "gather_tree",
]
