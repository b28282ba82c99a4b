"""Multi-process data parallelism over torch.distributed (counterpart of
sm3x/parallel/)."""

from sm3x_torch.parallel.collectives import (  # noqa: F401
    all_gather_varlen, all_reduce_sum, broadcast_string, cross_replica_mean,
    distributed_initialize, gather_rows, gather_rows_autograd, host_gather,
    host_gather_tree, is_distributed, is_main_process, max_over_ranks,
    process_info, shutdown)
