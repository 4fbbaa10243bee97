"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports no JAX, so that it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from pixflow_tpu_torch.ops.kernels import (fused_pair_sums, pair_sums, pair_sums_plain,
                                           point_sample, point_sample_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions
    return torch.device("cuda")


def _pair_inputs(dev, b, n, c, dtype, with_mask=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn(b, 1, c, device=dev, generator=g)
    unit = lambda x: (x / x.norm(dim=-1, keepdim=True)).to(dtype).contiguous()
    q = unit(base + torch.randn(b, n, c, device=dev, generator=g))
    k = unit(base + torch.randn(b, n, c, device=dev, generator=g))
    centers = [400 * torch.rand(b, n, device=dev, generator=g) for _ in range(4)]
    inv_diag = 1.0 / (40 + 50 * torch.rand(b, device=dev, generator=g))
    mask = ((torch.rand(b, n, device=dev, generator=g) > 0.3).float()
            if with_mask else None)
    return q, k, *centers, inv_diag, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c,with_mask", [(64, 49, 256, True), (3, 5, 300, False),
                                             (2, 100, 8, True)])
def test_pair_sums_kernel_matches_plain(dev, dtype, b, n, c, with_mask):
    args = _pair_inputs(dev, b, n, c, dtype, with_mask)
    before = pair_sums.launches
    got = pair_sums(*args, 0.7)
    want = pair_sums_plain(*args, 0.7)
    torch.cuda.synchronize()
    assert pair_sums.launches == before + 1
    assert torch.equal(got[:, 1], want[:, 1])  # exact counts, same f32 mask
    # the same f32 products summed in another order
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-4)
    again = pair_sums(*args, 0.7)
    assert torch.equal(got, again)  # fixed-order reduction: identical bits


def test_pair_sums_gradients_in_input_dtype(dev):
    args = _pair_inputs(dev, 4, 49, 64, torch.bfloat16)
    q, k = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    fused_pair_sums(q, k, *args[2:], 0.7)[:, 0].sum().backward()
    assert q.grad.dtype == torch.bfloat16 and k.grad.dtype == torch.bfloat16
    qp, kp = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    fused_pair_sums(qp, kp, *args[2:], 0.7, sums_fn=pair_sums_plain)[:, 0].sum().backward()
    assert torch.equal(q.grad, qp.grad) and torch.equal(k.grad, kp.grad)


def test_pair_sums_rejects_what_the_kernel_does_not_take(dev):
    args = list(_pair_inputs(dev, 2, 9, 16, torch.float32))
    with pytest.raises(ValueError):
        pair_sums(args[0].half(), args[1].half(), *args[2:], 0.7)
    with pytest.raises(ValueError):
        pair_sums(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:], 0.7)
    with pytest.raises(ValueError):
        pair_sums(args[0], args[1].cpu(), *args[2:], 0.7)


@pytest.mark.parametrize("up", [1, 8])
@pytest.mark.parametrize("b,h,w,c,n", [(64, 90, 160, 2, 196), (3, 7, 11, 3, 1000),
                                       (1, 1, 5, 2, 17)])
def test_point_sample_kernel_matches_plain(dev, up, b, h, w, c, n):
    g = torch.Generator(device=dev).manual_seed(up)
    field = torch.randn(b, h, w, c, device=dev, generator=g)
    u = torch.rand(b, n, 2, device=dev, generator=g)
    pts = torch.stack([u[..., 0] * (up * w + 8) - 5, u[..., 1] * (up * h + 8) - 5], -1)
    pts[0, :4] = torch.tensor([[0.0, 0.0], [up * w - 1.0, up * h - 1.0],
                               [-1.0, 0.5], [2.5, 1e9]], device=dev)
    pts = pts.contiguous()
    before = point_sample.launches
    got = point_sample(field, pts, up)
    want = point_sample_plain(field, pts, up)
    torch.cuda.synchronize()
    assert point_sample.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_point_sample_rejects_what_the_kernel_does_not_take(dev):
    field = torch.randn(2, 9, 16, 2, device=dev)
    pts = torch.rand(2, 5, 2, device=dev)
    with pytest.raises(ValueError):
        point_sample(field.double(), pts, 8)
    with pytest.raises(ValueError):
        point_sample(field.transpose(1, 2), pts, 8)
    with pytest.raises(ValueError):
        point_sample(field, pts[:1].contiguous(), 8)
    assert point_sample(field, torch.empty(2, 0, 2, device=dev), 8).shape == (2, 0, 2)
