"""The fused lazy flow_up kernel's plain version, held against the JAX package.

On the CPU, `flow_up_points` and `cycle_mask_points` take their plain
versions, so these tests pin the arithmetic that the CUDA kernel
(`csrc/flow_up_points.cu`) is compared with on the card to the JAX
package's `flow_up_warp_points` and `mask_ratio_estimate`, on the same numpy
inputs, in float32. The kernel itself is held against the plain version by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pixflow_tpu.ops import flow_points as jfp

from pixflow_tpu_torch.ops import flow_points as tfp
from pixflow_tpu_torch.ops.kernels import (cycle_mask_points, cycle_mask_points_plain,
                                           flow_up_points, flow_up_points_plain)
from pixflow_tpu_torch.ops.loss import bin_centers, fused_pair_geometry

T = torch.tensor  # copies: JAX hands out read-only buffers
J = jnp.asarray

H, W = 6, 9          # coarse field -> fine 48 x 72
HF, WF = 8 * H, 8 * W
K, B = 3, 2
A1, A2 = 0.01, 0.5


def _flows(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((K, B, H, W, 2))).astype(np.float32)


def _queries(seed, orig_h, orig_w, n=49):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, orig_w - 1, (B, n)).astype(np.float32)
    y = rng.uniform(0, orig_h - 1, (B, n)).astype(np.float32)
    return x, y


def _coords(seed, hf, wf):
    rng = np.random.default_rng(seed)
    out = np.zeros((B, 10), np.float32)
    for i in range(B):
        w, h = int(rng.integers(wf // 3, wf - 1)), int(rng.integers(hf // 3, hf - 1))
        j, ii = int(rng.integers(0, wf - w)), int(rng.integers(0, hf - h))
        out[i] = [j / (wf - 1), ii / (hf - 1), (j + w - 1) / (wf - 1),
                  (ii + h - 1) / (hf - 1), j, ii, w, h, wf, hf]
    return out


@pytest.mark.parametrize("is_norm", [False, True])
@pytest.mark.parametrize("orig_hw", [(HF, WF), (72, 108)])
def test_flow_up_points_plain_matches_jax(is_norm, orig_hw):
    fwd, bwd = _flows(40), _flows(41)
    x, y = _queries(42, *orig_hw)
    ho, wo = (np.full((B,), v, np.float32) for v in orig_hw)
    got = flow_up_points(T(fwd), T(bwd), T(x), T(y), T(wo), T(ho), A1, A2, is_norm)
    want = jfp.flow_up_warp_points(
        jfp.LazyFlowUp(flows=J(fwd), flows_rev=J(bwd), alpha1=A1, alpha2=A2,
                       is_norm=is_norm), J(x), J(y), (J(ho), J(wo)))
    # tolerances of tests/test_torch_ops.py: composition amplifies ulp-level
    # differences (contraction order, reciprocals) for a handful of points
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)
    assert got[2].dtype == torch.float32
    assert (got[2].numpy().astype(bool) == np.asarray(want[2])).mean() > 0.995


@pytest.mark.parametrize("is_norm", [False, True])
def test_flow_up_points_without_mask_matches_jax(is_norm):
    fwd = _flows(43)
    x, y = _queries(44, HF, WF)
    ho, wo = np.full((B,), HF, np.float32), np.full((B,), WF, np.float32)
    out_x, out_y, mask = flow_up_points(T(fwd), None, T(x), T(y), T(wo), T(ho),
                                        is_norm=is_norm)
    want = jfp.flow_up_warp_points(jfp.LazyFlowUp(flows=J(fwd), is_norm=is_norm),
                                   J(x), J(y), (J(ho), J(wo)))
    assert mask is None and want[2] is None
    np.testing.assert_allclose(out_x.numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out_y.numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("is_norm", [False, True])
def test_cycle_mask_points_plain_matches_jax(is_norm):
    fwd, bwd = _flows(45), _flows(46)
    ys, xs = np.meshgrid(np.arange(0, HF, 3), np.arange(0, WF, 3), indexing="ij")
    pts = np.ascontiguousarray(np.broadcast_to(
        np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32), (B, xs.size, 2)))
    got = cycle_mask_points(T(fwd), T(bwd), T(pts), A1, A2, is_norm)
    want = np.asarray(jfp.cycle_mask_at(J(fwd), J(bwd), J(pts), A1, A2, is_norm))
    assert got.shape == (B, xs.size) and got.dtype == torch.float32
    # boolean thresholds may flip right at the decision boundary
    assert (got.numpy().astype(bool) == want).mean() > 0.995
    assert 0.0 < float(got.mean()) < 1.0  # both outcomes occur


@pytest.mark.parametrize("is_norm", [False, True])
def test_mask_ratio_estimate_matches_jax(is_norm):
    fwd, bwd = _flows(47), _flows(48)
    got = tfp.mask_ratio_estimate(T(fwd), T(bwd), A1, A2, is_norm, stride=4)
    plain = tfp.mask_ratio_estimate(T(fwd), T(bwd), A1, A2, is_norm, stride=4, plain=True)
    want = np.asarray(jfp.mask_ratio_estimate(J(fwd), J(bwd), A1, A2, is_norm, stride=4))
    # one flipped boundary point of the 216 per sample moves it by 1/216
    np.testing.assert_allclose(got.numpy(), want, atol=2.0 / 216)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_wrappers_on_cpu_take_the_plain_version():
    fwd, bwd = _flows(49), _flows(50)
    x, y = _queries(51, HF, WF)
    wo, ho = T(np.full((B,), WF, np.float32)), T(np.full((B,), HF, np.float32))
    before = flow_up_points.launches
    got = flow_up_points(T(fwd), T(bwd), T(x), T(y), wo, ho, A1, A2)
    want = flow_up_points_plain(T(fwd), T(bwd), T(x), T(y), wo, ho, A1, A2)
    pts = T(np.stack([x, y], -1) % 40.0)
    m = cycle_mask_points(T(fwd), T(bwd), pts, A1, A2)
    assert flow_up_points.launches == before  # only a kernel launch counts
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        # K1's input layout
        assert g.shape == (B, 49) and g.dtype == torch.float32 and g.is_contiguous()
    assert torch.equal(m, cycle_mask_points_plain(T(fwd), T(bwd), pts, A1, A2))


def test_pair_geometry_reads_the_lazy_flow_in_k1_layout():
    fwd, bwd = _flows(52), _flows(53)
    cq, ck = T(_coords(54, HF, WF)), T(_coords(55, HF, WF))
    lf = tfp.LazyFlowUp(T(fwd), T(bwd), A1, A2)
    qx, qy, kx, ky, inv_diag, pts_mask = fused_pair_geometry(cq, ck, (7, 7), lf)
    x, y = bin_centers(cq, (7, 7))
    wx, wy, wm = tfp.flow_up_warp_points(lf, x, y, (cq[:, 9], cq[:, 8]))
    assert torch.equal(qx, wx.reshape(B, 49)) and torch.equal(qy, wy.reshape(B, 49))
    assert pts_mask.dtype == torch.float32 and pts_mask.is_contiguous()
    assert torch.equal(pts_mask.bool(), wm.reshape(B, 49))
    # the plain switch gives the same numbers on the CPU
    px, py, pm = tfp.lazy_warp_points(tfp.LazyFlowUp(T(fwd), T(bwd), A1, A2, plain=True),
                                      x, y, (cq[:, 9], cq[:, 8]))
    assert torch.equal(px, qx) and torch.equal(py, qy) and torch.equal(pm, pts_mask)


def test_lazy_flow_with_alphas_needs_reverse_flows():
    x, y = (T(v) for v in _queries(56, HF, WF))
    orig = (T(np.full((B,), HF, np.float32)), T(np.full((B,), WF, np.float32)))
    with pytest.raises(ValueError):
        tfp.flow_up_warp_points(tfp.LazyFlowUp(T(_flows(57)), None, A1, A2), x, y, orig)
