"""Multi-process data and tensor parallelism over torch.distributed
(counterpart of sm3x/parallel/; the tensor-parallel operators and the
split state dicts are in sm3x_torch.parallel.tensor)."""

from sm3x_torch.parallel.collectives import (  # noqa: F401
    all_gather_varlen, all_reduce_sum, broadcast_string, cross_replica_mean,
    distributed_initialize, gather_list, gather_objects, gather_rows,
    gather_rows_autograd, group_info, host_gather, host_gather_tree,
    is_distributed, is_main_process, max_over_ranks, process_info, shutdown)
from sm3x_torch.core.mesh import DATA_AXIS, MODEL_AXIS, make_mesh  # noqa: F401
