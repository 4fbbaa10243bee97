from .flow_points import (LazyFlowUp, advect_up, composed_flow_at,
                          composite_weights_1d, cycle_mask_at,
                          flow_up_warp_points, lazy_warp_points,
                          mask_ratio_estimate, sample_up)
from .loss import (bin_centers, instance_loss, l2_normalize, pair_loss_geometry,
                   pixpro_pair_loss, pixpro_pair_loss_fused, ppm_attention,
                   warp_points_with_flow)
from .resample import (coords_grid, denormalize_flow, grid_sample,
                       grid_sample_nearest, normalize_coords, normalize_flow)

__all__ = ["LazyFlowUp", "advect_up", "bin_centers", "composed_flow_at",
           "composite_weights_1d", "coords_grid", "cycle_mask_at",
           "denormalize_flow", "flow_up_warp_points", "grid_sample",
           "grid_sample_nearest", "instance_loss", "l2_normalize",
           "lazy_warp_points",
           "mask_ratio_estimate", "normalize_coords", "normalize_flow",
           "pair_loss_geometry", "pixpro_pair_loss", "pixpro_pair_loss_fused",
           "ppm_attention", "sample_up", "warp_points_with_flow"]
