from selfpose3d_tpu_torch.parallel.mesh import (
    AllReduceSum,
    agree_max,
    all_reduce_max,
    all_reduce_sum,
    barrier,
    init_distributed,
    local_batch_size,
    mean_over_ranks,
    process_allgather_tree,
    rank,
    world,
    wrap_model,
)

__all__ = [
    "AllReduceSum",
    "agree_max",
    "all_reduce_max",
    "all_reduce_sum",
    "barrier",
    "init_distributed",
    "local_batch_size",
    "mean_over_ranks",
    "process_allgather_tree",
    "rank",
    "world",
    "wrap_model",
]
