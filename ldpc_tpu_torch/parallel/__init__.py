"""Multi-process runs of the port (counterpart of `ldpc_tpu/parallel/`):
one process a device, the batch's lanes split over a process mesh, the
counters summed over it."""
from .mesh import (all_sum, batch_multiple, exit_process, init_distributed,
                   is_rank0, make_mesh, on_rank0, pick_backend, shard_lanes)

__all__ = ["make_mesh", "batch_multiple", "init_distributed", "shard_lanes",
           "all_sum", "is_rank0", "on_rank0", "pick_backend",
           "exit_process"]
