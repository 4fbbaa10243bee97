"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports no JAX, so that it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.ops.kernels import (cycle_mask_points, cycle_mask_points_plain,
                                           flow_up_points, flow_up_points_plain,
                                           fused_pair_sums, pair_sums, pair_sums_backward,
                                           pair_sums_backward_plain, pair_sums_plain,
                                           point_sample, point_sample_plain)
from pixflow_tpu_torch.ops.loss import bin_centers
from pixflow_tpu_torch.train import synthetic_batch

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


def _bf16_ulp(x):
    x = x.float()
    ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8)
    return torch.where(x == 0, torch.zeros_like(x), ulp)


def _magnitudes(args, g, need_dq=True, need_dk=True):
    """For each gradient element, the sum of its terms' magnitudes |g M x_t|:
    the plain backward on |q|, |k| and |g| (M and pts_mask are >= 0)."""
    q, k, *geometry = args
    return pair_sums_backward_plain(q.abs(), k.abs(), *geometry, g.abs(), 0.7,
                                    need_dq, need_dk)


def assert_grad_close(got, want, mag):
    """f32: rtol 1e-5, atol 1e-6 max|want|. bf16: each element within one
    bf16 ulp of the plain version's, or one ulp of `mag` (the sum of its
    terms' magnitudes) where that is larger. The kernel runs the plain
    version's ascending f32 FMA chain with its zero terms left out, and
    matches it to the bit at the tested shapes; but that order is cuBLAS's
    choice, and where the terms cancel, another order leaves another residue."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))
        return
    allowed = torch.maximum(_bf16_ulp(want), _bf16_ulp(mag))
    err = (got.float() - want.float()).abs()
    assert bool((err <= allowed).all()), f"{int((err > allowed).sum())} elements off by > 1 ulp"


def test_pair_sums_gradients_in_input_dtype(dev):
    args = _pair_inputs(dev, 4, 49, 64, torch.bfloat16)
    q, k = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    fused_pair_sums(q, k, *args[2:], 0.7)[:, 0].sum().backward()
    assert q.grad.dtype == torch.bfloat16 and k.grad.dtype == torch.bfloat16
    qp, kp = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    fused_pair_sums(qp, kp, *args[2:], 0.7, plain=True)[:, 0].sum().backward()
    mag = _magnitudes(args, torch.ones(4, device=dev))
    assert_grad_close(q.grad, qp.grad, mag[0])
    assert_grad_close(k.grad, kp.grad, mag[1])


def test_pair_sums_rejects_what_the_kernel_does_not_take(dev):
    args = list(_pair_inputs(dev, 2, 9, 16, torch.float32))
    with pytest.raises(ValueError):
        pair_sums(args[0].half(), args[1].half(), *args[2:], 0.7)
    with pytest.raises(ValueError):
        pair_sums(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:], 0.7)
    with pytest.raises(ValueError):
        pair_sums(args[0], args[1].cpu(), *args[2:], 0.7)


@pytest.mark.parametrize("need_dk", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", [(64, 49, 256), (3, 5, 300), (2, 100, 8)])
def test_pair_sums_backward_kernel_matches_plain(dev, dtype, b, n, c, with_mask, need_dk):
    args = _pair_inputs(dev, b, n, c, dtype, with_mask)
    g = torch.randn(b, 2, device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    g = g[:, 0]  # strided, as autograd hands it over
    before = pair_sums_backward.launches
    got = pair_sums_backward(*args, g, 0.7, True, need_dk)
    want = pair_sums_backward_plain(*args, g, 0.7, True, need_dk)
    torch.cuda.synchronize()
    assert pair_sums_backward.launches == before + 1
    mag = _magnitudes(args, g, True, need_dk)
    assert_grad_close(got[0], want[0], mag[0])
    if need_dk:
        assert_grad_close(got[1], want[1], mag[1])
    else:
        assert got[1] is None
    again = pair_sums_backward(*args, g, 0.7, True, need_dk)
    assert all(a is None or torch.equal(a, r) for a, r in zip(got, again))  # identical bits


def test_pair_sums_mask_at_the_threshold(dev):
    """Query centers ulp by ulp either side of pos_ratio / inv_diag: the
    kernels must give the plain version's mask to the bit, also for a sample
    with inv_diag 0 (every pair positive)."""
    b, n, c = 8, 64, 16
    g = torch.Generator(device=dev).manual_seed(4)
    inv = 1.0 / (40 + 50 * torch.rand(b, device=dev, generator=g))
    inv[-1] = 0.0
    edge = (0.7 / inv[:-1]).view(b - 1, 1).view(torch.int32)
    steps = torch.arange(-n // 2, n - n // 2, device=dev, dtype=torch.int32)
    qx = torch.cat([(edge + steps).view(torch.float32),
                    torch.rand(1, n, device=dev, generator=g)]).contiguous()
    zeros = torch.zeros(b, n, device=dev)
    ky = (1e-3 * torch.arange(n, device=dev, dtype=torch.float32)).expand(b, n).contiguous()
    q, k = (torch.randn(b, n, c, device=dev, generator=g) for _ in range(2))
    args = (q, k, qx, zeros, zeros.clone(), ky, inv, None)
    got, want = pair_sums(*args, 0.7), pair_sums_plain(*args, 0.7)
    assert torch.equal(got[:, 1], want[:, 1])
    assert 0 < float(want[:-1, 1].min()) and float(want[:-1, 1].max()) < n * n
    gb = torch.ones(b, device=dev)
    for a, w in zip(pair_sums_backward(*args, gb, 0.7), pair_sums_backward_plain(*args, gb, 0.7)):
        assert torch.equal(a, w)


def test_pair_sums_backward_dk_alone(dev):
    args = _pair_inputs(dev, 4, 49, 64, torch.bfloat16)
    g = torch.linspace(-1, 1, 4, device=dev)
    dq, dk = pair_sums_backward(*args, g, 0.7, False, True)
    assert dq is None
    assert_grad_close(dk, pair_sums_backward_plain(*args, g, 0.7, False, True)[1],
                      _magnitudes(args, g, False, True)[1])


def test_pair_sums_backward_rejects_what_the_kernel_does_not_take(dev):
    args = list(_pair_inputs(dev, 2, 9, 16, torch.float32))
    g = torch.ones(2, device=dev)
    with pytest.raises(ValueError):
        pair_sums_backward(args[0].half(), args[1].half(), *args[2:], g, 0.7)
    with pytest.raises(ValueError):
        pair_sums_backward(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:],
                           g, 0.7)
    with pytest.raises(ValueError):
        pair_sums_backward(args[0], args[1].cpu(), *args[2:], g, 0.7)
    with pytest.raises(ValueError):
        pair_sums_backward(*args, g.cpu(), 0.7)
    with pytest.raises(ValueError):
        pair_sums_backward(*args, g.double(), 0.7)


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


# --- the fused lazy flow_up kernel ------------------------------------------

A1, A2 = 0.01, 0.5


def _lazy_inputs(dev, batch, orig_hw, seed):
    """The recipe's flows (K=5, smooth, 1/8 of `orig_hw`) and its 49 query bin
    centers per sample, from the synthetic batch."""
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.batch_size = batch
    bt = {k: torch.as_tensor(v).to(dev) for k, v in
          synthetic_batch(cfg, seed=seed, orig_hw=orig_hw).items()}
    fwd = bt["flows_fwd"].transpose(0, 1).contiguous()
    bwd = bt["flows_bwd"].transpose(0, 1).contiguous()
    x, y = bin_centers(bt["coord1"], (7, 7))
    c = bt["coord1"]
    return fwd, bwd, x.reshape(batch, -1).contiguous(), y.reshape(batch, -1).contiguous(), \
        c[:, 8], c[:, 9]


# (batch, original frame): a small one, and the recipe's 64 x 720p
LAZY_SHAPES = [(3, (96, 160)), (64, (720, 1280))]


@pytest.mark.parametrize("is_norm", [False, True])
@pytest.mark.parametrize("batch,orig_hw", LAZY_SHAPES)
def test_flow_up_points_kernel_matches_plain(dev, batch, orig_hw, is_norm):
    fwd, bwd, x, y, wo, ho = _lazy_inputs(dev, batch, orig_hw, seed=3)
    before = flow_up_points.launches
    got = flow_up_points(fwd, bwd, x, y, wo, ho, A1, A2, is_norm)
    want = flow_up_points_plain(fwd, bwd, x, y, wo, ho, A1, A2, is_norm)
    torch.cuda.synchronize()
    assert flow_up_points.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == (batch, 49) and g.dtype == torch.float32 and g.is_contiguous()
    # the plain version's contractions sum in another order (cuBLAS), and
    # composition amplifies the last bits: positions within 1e-3 px
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)
    assert float((got[2] == want[2]).float().mean()) >= 0.995


@pytest.mark.parametrize("is_norm", [False, True])
@pytest.mark.parametrize("batch,orig_hw", LAZY_SHAPES)
def test_cycle_mask_points_kernel_matches_plain(dev, batch, orig_hw, is_norm):
    fwd, bwd, *_ = _lazy_inputs(dev, batch, orig_hw, seed=4)
    hf, wf = 8 * fwd.shape[2], 8 * fwd.shape[3]
    gy, gx = torch.meshgrid(torch.arange(0, hf, 8, device=dev, dtype=torch.float32),
                            torch.arange(0, wf, 8, device=dev, dtype=torch.float32),
                            indexing="ij")
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)[None].expand(batch, -1, -1)
    pts = pts.contiguous()
    before = flow_up_points.launches
    got = cycle_mask_points(fwd, bwd, pts, A1, A2, is_norm)
    want = cycle_mask_points_plain(fwd, bwd, pts, A1, A2, is_norm)
    torch.cuda.synchronize()
    assert flow_up_points.launches == before + 1
    assert got.shape == want.shape == pts.shape[:2]
    assert float((got == want).float().mean()) >= 0.995
    assert 0.0 < float(want.mean()) < 1.0


def test_flow_up_points_without_mask(dev):
    fwd, _, x, y, wo, ho = _lazy_inputs(dev, 3, (96, 160), seed=5)
    out_x, out_y, mask = flow_up_points(fwd, None, x, y, wo, ho)
    want = flow_up_points_plain(fwd, None, x, y, wo, ho)
    assert mask is None and want[2] is None
    torch.testing.assert_close(out_x, want[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(out_y, want[1], rtol=0, atol=1e-3)


def test_flow_up_points_rejects_what_the_kernel_does_not_take(dev):
    fwd, bwd, x, y, wo, ho = _lazy_inputs(dev, 2, (96, 160), seed=6)
    with pytest.raises(ValueError):
        flow_up_points(fwd.double(), bwd.double(), x, y, wo, ho, A1, A2)
    with pytest.raises(ValueError):
        flow_up_points(fwd, bwd, x.cpu(), y, wo, ho, A1, A2)
    with pytest.raises(ValueError):
        flow_up_points(fwd, bwd, x[:1].contiguous(), y[:1].contiguous(), wo, ho, A1, A2)
    with pytest.raises(ValueError):
        flow_up_points(fwd.transpose(2, 3), bwd, x, y, wo, ho, A1, A2)
    with pytest.raises(ValueError):
        flow_up_points(fwd, bwd, x, y, wo, ho)  # a mask needs its alphas
    with pytest.raises(ValueError):
        cycle_mask_points(fwd, bwd, torch.zeros(2, 5, 3, device=dev), A1, A2)
    with pytest.raises(ValueError):
        cycle_mask_points(fwd, None, torch.zeros(2, 5, 2, device=dev), A1, A2)
