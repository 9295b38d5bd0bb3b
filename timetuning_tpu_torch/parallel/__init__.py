from timetuning_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_gather_rows,
    all_reduce_mean,
    all_reduce_sum,
    broadcast_tensors,
    data_group,
    data_rank,
    data_world_size,
    init_from_env,
    is_initialized,
    make_2d_mesh,
    shard_batch,
)

__all__ = ["DATA_AXIS", "all_gather_rows", "all_reduce_mean", "all_reduce_sum",
           "broadcast_tensors", "data_group", "data_rank", "data_world_size",
           "init_from_env", "is_initialized", "make_2d_mesh", "shard_batch"]
