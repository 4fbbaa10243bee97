"""PyTorch / CUDA port of `pixflow_tpu`, for one NVIDIA H100 (Hopper).

The JAX package `pixflow_tpu` stays the reference; this package mirrors its
module names (`ops/flow_points.py` here is the counterpart of
`pixflow_tpu/ops/flow_points.py`, and so on) and imports nothing from it.

Layout rule. Public functions keep the JAX package's layouts, so the tests
compare like with like:

    images          [B, H, W, 3]   (uint8 batches, normalized on the device)
    feature maps    [B, h, w, C]
    flow stacks     [B, K, h, w, 2] in a batch, [K, B, h, w, 2] in the step
    crop coords     [B, 10]
    sampling points [B, N, 2] as (x, y) pixels

Convolutions run NCHW tensors in `channels_last` memory, which is the same
bytes as NHWC: the ResNet permutes views, not data. Parameter names follow
the reference's torch names (`encoder.layer2.0.downsample.0.weight`,
`projector.linear1.weight`), so `models/convert.py` and the JAX package's
`torch_pixpro_to_flax` map weights both ways.

Devices. Entry points run on `cuda` unless the caller passes `device="cpu"`
(`device.py`). The hand-written CUDA kernels (`ops/kernels/`) launch for
CUDA tensors; a tensor on the CPU takes the kernel's plain PyTorch version.
"""
