"""The port's hand-written CUDA kernels (sources in `pixflow_tpu_torch/csrc`),
each with its plain PyTorch version and a `launches` counter on its wrapper.

    K1 pair_sums     <- pixflow_tpu/ops/pallas/pair_loss.py:_pair_kernel
       pair_sums_backward  its analytic VJP `_bwd` in the same file, which
                        the JAX package leaves to XLA
    K2 point_sample  <- pixflow_tpu/ops/pallas/warp.py:_warp_kernel
       grid_sample      its read at a normalised grid in the gather's op
                        order, for the materialising flow algebra and
                        RAFT's correlation lookup
       flow_up_points   the lazy flow_up evaluation of one direction in one
                        launch: K2's tap logic, redesigned for the train
                        step's path (15 K2 launches and their ops before)
"""

from .pair_sums import (fused_pair_sums, pair_mask, pair_sums, pair_sums_backward,
                        pair_sums_backward_plain, pair_sums_plain)
from .flow_up_points import (cycle_mask_points, cycle_mask_points_plain,
                             flow_up_points, flow_up_points_plain)
from .point_sample import (composite_weights_1d, grid_sample, point_sample,
                           point_sample_plain)

KERNELS = (pair_sums, pair_sums_backward, point_sample, flow_up_points, grid_sample)

__all__ = ["KERNELS", "composite_weights_1d", "cycle_mask_points",
           "cycle_mask_points_plain", "flow_up_points", "flow_up_points_plain",
           "fused_pair_sums", "grid_sample", "pair_mask", "pair_sums", "pair_sums_backward",
           "pair_sums_backward_plain", "pair_sums_plain", "point_sample",
           "point_sample_plain"]
