"""Host data pipeline: the port's own copy of `pixflow_tpu/data/` (numpy,
PIL and ctypes, no JAX), with the same exports. Its loader gives the same
batches as the JAX package's on the same corpus and seed."""

from .transforms import get_transform, RandomResizedCropCoord, TransformCompose
from .datasets import (
    VideoFrameDataset, list_image_folder, list_annotation_file,
    list_coco_annotations, IMG_EXTENSIONS,
)
from .loader import ShardedLoader, build_pretrain_loader

__all__ = [
    "get_transform", "RandomResizedCropCoord", "TransformCompose",
    "VideoFrameDataset", "list_image_folder", "list_annotation_file",
    "list_coco_annotations",
    "IMG_EXTENSIONS", "ShardedLoader", "build_pretrain_loader",
]
