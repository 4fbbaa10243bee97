"""The port's hand-written CUDA kernels (sources in `pixflow_tpu_torch/csrc`),
each with its plain PyTorch version and a `launches` counter on its wrapper.

    K1 pair_sums     <- pixflow_tpu/ops/pallas/pair_loss.py:_pair_kernel
    K2 point_sample  <- pixflow_tpu/ops/pallas/warp.py:_warp_kernel
"""

from .pair_sums import fused_pair_sums, pair_mask, pair_sums, pair_sums_plain
from .point_sample import composite_weights_1d, point_sample, point_sample_plain

KERNELS = (pair_sums, point_sample)

__all__ = ["KERNELS", "composite_weights_1d", "fused_pair_sums", "pair_mask",
           "pair_sums", "pair_sums_plain", "point_sample", "point_sample_plain"]
