"""The port's hand-written CUDA kernels (sources in `pixflow_tpu_torch/csrc`),
each with its plain PyTorch version and a `launches` counter on its wrapper.

    K1 pair_sums     <- pixflow_tpu/ops/pallas/pair_loss.py:_pair_kernel
       pair_sums_backward  its analytic VJP `_bwd` in the same file, which
                        the JAX package leaves to XLA
    K2 point_sample  <- pixflow_tpu/ops/pallas/warp.py:_warp_kernel
       grid_sample      its read at a normalised grid in the gather's op
                        order, for the materialising flow algebra and
                        RAFT's correlation lookup
       grid_sample_backward  that read's gradient for the field, which the
                        JAX package leaves to XLA's autodiff; with the
                        entry, `grid_sample_with_grad`, RAFT's training
       flow_up_points   the lazy flow_up evaluation of one direction in one
                        launch: K2's tap logic, redesigned for the train
                        step's path (15 K2 launches and their ops before)
"""

from .pair_sums import (fused_pair_sums, pair_mask, pair_sums, pair_sums_backward,
                        pair_sums_backward_plain, pair_sums_plain)
from .flow_up_points import (cycle_mask_points, cycle_mask_points_plain,
                             flow_up_points, flow_up_points_plain)
from .point_sample import (composite_weights_1d, grid_sample, grid_sample_backward,
                           grid_sample_backward_plain, grid_sample_with_grad,
                           point_sample, point_sample_plain)

# the kernels a pretraining step can launch (the driver logs their counts);
# RAFT training adds grid_sample_backward
KERNELS = (pair_sums, pair_sums_backward, point_sample, flow_up_points, grid_sample)
RAFT_TRAIN_KERNELS = (grid_sample, grid_sample_backward)

__all__ = ["KERNELS", "RAFT_TRAIN_KERNELS", "composite_weights_1d", "cycle_mask_points",
           "cycle_mask_points_plain", "flow_up_points", "flow_up_points_plain",
           "fused_pair_sums", "grid_sample", "grid_sample_backward",
           "grid_sample_backward_plain", "grid_sample_with_grad", "pair_mask", "pair_sums", "pair_sums_backward",
           "pair_sums_backward_plain", "pair_sums_plain", "point_sample",
           "point_sample_plain"]
