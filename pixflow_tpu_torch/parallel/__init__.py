"""Data parallelism across processes, one a card: the port of
`pixflow_tpu/parallel/` on `torch.distributed` (`dist.py`: the group;
`multihost.py`: the cross-rank helpers)."""

from .dist import (Dist, check_mesh_shape, init_distributed, shutdown, torchrun_env,
                   use_device, world_size)
from .multihost import (all_reduce_mean, all_reduce_sum_, any_process,
                        broadcast_module_, host_mean, host_sum, local_rows)

__all__ = ["Dist", "all_reduce_mean", "all_reduce_sum_", "any_process",
           "broadcast_module_", "check_mesh_shape", "host_mean", "host_sum",
           "init_distributed", "local_rows", "shutdown", "torchrun_env", "use_device",
           "world_size"]
