"""The port's ops (resample, loss geometry, PPM attention, the lazy flow_up
point evaluation) held against the JAX package on the same numpy inputs, in
float32 on the CPU, at the tolerances of the JAX package's own tests."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pixflow_tpu.ops import flow_points as jfp
from pixflow_tpu.ops import loss as jloss
from pixflow_tpu.ops import resample as jres

from pixflow_tpu_torch.ops import flow_points as tfp
from pixflow_tpu_torch.ops import loss as tloss
from pixflow_tpu_torch.ops import resample as tres

from torch_threads import cap_torch_threads

cap_torch_threads()

T = torch.tensor  # copies: JAX hands out read-only buffers
J = jnp.asarray

H, W = 6, 9          # coarse field -> fine 48 x 72 (tests/test_flow_points.py)
HF, WF = 8 * H, 8 * W
K, B = 3, 2
A1, A2 = 0.01, 0.5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flows(seed, k=K, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((k, B, H, W, 2))).astype(np.float32)


def _pts(seed, n=64, pad=3.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-pad, WF - 1 + pad, (B, n)).astype(np.float32)
    y = rng.uniform(-pad, HF - 1 + pad, (B, n)).astype(np.float32)
    return np.stack([x, y], axis=-1)


def _grid_pts():
    ys, xs = np.meshgrid(np.arange(HF), np.arange(WF), indexing="ij")
    return np.ascontiguousarray(np.broadcast_to(
        np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)[None],
        (B, HF * WF, 2)))


def _coords(seed, n=B, hf=HF, wf=WF):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 10), np.float32)
    for i in range(n):
        w = int(rng.integers(wf // 3, wf - 1))
        h = int(rng.integers(hf // 3, hf - 1))
        j = int(rng.integers(0, wf - w))
        ii = int(rng.integers(0, hf - h))
        out[i] = [j / (wf - 1), ii / (hf - 1), (j + w - 1) / (wf - 1),
                  (ii + h - 1) / (hf - 1), j, ii, w, h, wf, hf]
    return out


# --- resample -------------------------------------------------------------

# Where the two packages evaluate the same float32 expression in the same
# order, results agree to a few ulp: rtol 1e-6, with atol for values near 0.


def test_coords_and_normalization_helpers():
    np.testing.assert_array_equal(_np(tres.coords_grid(5, 7)),
                                  _np(jres.coords_grid(5, 7)))
    rng = np.random.default_rng(0)
    c = rng.uniform(-5, 50, (3, 4, 2)).astype(np.float32)
    for tf, jf in ((tres.normalize_coords, jres.normalize_coords),
                   (tres.normalize_flow, jres.normalize_flow),
                   (tres.denormalize_flow, jres.denormalize_flow)):
        np.testing.assert_allclose(_np(tf(T(c), 30, 40)), _np(jf(J(c), 30, 40)),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nearest", [False, True])
def test_grid_sample_matches_jax(nearest):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 11, 13, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 7, 5, 2)).astype(np.float32)
    # include exact half-pixel positions: nearest rounds them half to even
    grid[0, 0, :, 0] = 2.0 * (np.arange(5) + 0.5) / 12 - 1.0
    tf, jf = ((tres.grid_sample_nearest, jres.grid_sample_nearest) if nearest
              else (tres.grid_sample, jres.grid_sample))
    # same expressions: a few ulp
    np.testing.assert_allclose(_np(tf(T(img), T(grid))), _np(jf(J(img), J(grid))),
                               rtol=1e-6, atol=1e-6)


# --- loss geometry and attention ------------------------------------------

def test_bin_centers_match_jax():
    c = _coords(1, n=3, hf=720, wf=1280)
    for got, want in zip(tloss.bin_centers(T(c), (7, 7)), jloss.bin_centers(J(c), (7, 7))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_warp_points_with_dense_flow_matches_jax(masked):
    rng = np.random.default_rng(2)
    flow = (4 * rng.standard_normal((B, H, W, 2))).astype(np.float32)
    x = rng.uniform(0, WF - 1, (B, 7, 7)).astype(np.float32)
    y = rng.uniform(0, HF - 1, (B, 7, 7)).astype(np.float32)
    mask = rng.random((B, H, W)) > 0.3 if masked else None
    orig = (np.full((B,), HF, np.float32), np.full((B,), WF, np.float32))
    got = tloss.warp_points_with_flow(T(flow), T(x), T(y), tuple(map(T, orig)),
                                      None if mask is None else T(mask))
    want = jloss.warp_points_with_flow(J(flow), J(x), J(y), tuple(map(J, orig)),
                                       None if mask is None else J(mask))
    # same expressions on coordinates of tens of pixels: a few ulp
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-6, atol=1e-5)
    if masked:
        np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    else:
        assert got[2] is None


@pytest.mark.parametrize("masked", [False, True])
def test_warp_points_with_lazy_flow_matches_jax(masked):
    fwd, bwd = _flows(7), _flows(8)
    a1, a2 = (A1, A2) if masked else (None, None)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, WF - 1, (B, 7, 7)).astype(np.float32)
    y = rng.uniform(0, HF - 1, (B, 7, 7)).astype(np.float32)
    orig = (np.full((B,), HF, np.float32), np.full((B,), WF, np.float32))
    got = tloss.warp_points_with_flow(
        tfp.LazyFlowUp(T(fwd), T(bwd), a1, a2), T(x), T(y), tuple(map(T, orig)))
    want = jloss.warp_points_with_flow(
        jfp.LazyFlowUp(flows=J(fwd), flows_rev=J(bwd), alpha1=a1, alpha2=a2),
        J(x), J(y), tuple(map(J, orig)))
    # tolerances of tests/test_flow_points.py (lazy vs materialized points)
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=1e-4, atol=2e-3)
    if masked:
        assert (_np(got[2]) == _np(want[2])).mean() > 0.995
    else:
        assert got[2] is None and want[2] is None


def _smooth_flows(seed, k, b, h, w, amp):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    a = rng.uniform(-1, 1, (k, b, 2, 4, 1, 1))
    f = amp * (a[..., 0, :, :] + a[..., 1, :, :] * np.sin(3 * xx + a[..., 2, :, :])
               * np.cos(2 * yy + a[..., 3, :, :]))
    return np.ascontiguousarray(np.moveaxis(f, 2, -1)).astype(np.float32)


@pytest.mark.parametrize("lazy", [False, True])
def test_warp_points_at_another_original_size_matches_jax(lazy):
    """Frames of 1080 x 1920 with flows of 720 x 1280: the flow is rescaled by
    the ratio wf / W_orig, a true float32 division in the JAX package (720 /
    1080 is 0.6666666865; a reciprocal times 720 gives 0.6666666269)."""
    rng = np.random.default_rng(30)
    # points near the origin, so that one ulp of the rescaled flow shows
    x = rng.uniform(0, 40, (B, 7, 7)).astype(np.float32)
    y = rng.uniform(0, 40, (B, 7, 7)).astype(np.float32)
    orig = (np.full((B,), 1080, np.float32), np.full((B,), 1920, np.float32))
    if not lazy:
        flow = (60 + 20 * rng.standard_normal((B, 720, 1280, 2))).astype(np.float32)
        got = tloss.warp_points_with_flow(T(flow), T(x), T(y), tuple(map(T, orig)))
        want = jloss.warp_points_with_flow(J(flow), J(x), J(y), tuple(map(J, orig)))
        # the same float32 expressions end to end: equal bits
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
        return
    fwd, bwd = _smooth_flows(31, 5, B, 90, 160, 1.0), _smooth_flows(32, 5, B, 90, 160, 1.0)
    got = tfp.flow_up_warp_points(tfp.LazyFlowUp(T(fwd), T(bwd), A1, A2),
                                  T(x), T(y), tuple(map(T, orig)))
    want = jfp.flow_up_warp_points(
        jfp.LazyFlowUp(flows=J(fwd), flows_rev=J(bwd), alpha1=A1, alpha2=A2),
        J(x), J(y), tuple(map(J, orig)))
    # the composed flows of the two packages differ in the last bits where
    # their contractions sum in another order; where they agree bit for bit,
    # the warped points must too
    f32 = np.float32
    fine = np.stack([((f32(2) * x / f32(1919) - f32(1)) + f32(1)) * f32(0.5) * f32(1279),
                     ((f32(2) * y / f32(1079) - f32(1)) + f32(1)) * f32(0.5) * f32(719)],
                    -1).reshape(B, -1, 2)
    f_t = _np(tfp.composed_flow_at(T(fwd), T(fine)))
    f_j = _np(jfp.composed_flow_at(J(fwd), J(fine)))
    same = (f_t == f_j).all(-1).reshape(x.shape)
    assert same.sum() >= 10
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(_np(g)[same], _np(w)[same])
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-3)
    assert (_np(got[2]) == _np(want[2])).mean() > 0.995


def test_pair_loss_geometry_and_loss_match_jax():
    rng = np.random.default_rng(12)
    fwd, bwd = _flows(10), _flows(11)
    q = rng.standard_normal((B, 7, 7, 16)).astype(np.float32)
    k = rng.standard_normal((B, 7, 7, 16)).astype(np.float32)
    cq, ck = _coords(13), _coords(14)
    got_loss, (got_pn, got_pm) = tloss.pixpro_pair_loss(
        T(q), T(k), T(cq), T(ck), 0.7, flow=tfp.LazyFlowUp(T(fwd), T(bwd), A1, A2))
    want_loss, (want_pn, want_pm) = jloss.pixpro_pair_loss(
        J(q), J(k), J(cq), J(ck), 0.7,
        flow=jfp.LazyFlowUp(flows=J(fwd), flows_rev=J(bwd), alpha1=A1, alpha2=A2))
    # tolerances of tests/test_flow_points.py::test_pair_loss_parity_lazy_vs_materialized
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(got_pn), _np(want_pn))
    np.testing.assert_allclose(_np(got_pm), _np(want_pm), rtol=1e-6)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_ppm_attention_matches_jax(p):
    rng = np.random.default_rng(15)
    feat = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    value = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    got = tloss.ppm_attention(T(feat), T(value), p=p)
    want = jloss.ppm_attention(J(feat), J(value), p=p)
    # two libraries' f32 matrix products: sums in another order
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-6)
    x = tloss.l2_normalize(T(feat[:, 0, 0]))
    y = tloss.l2_normalize(T(value[:, 0, 0]))
    np.testing.assert_allclose(
        float(tloss.instance_loss(x, y)),
        float(jloss.instance_loss(jloss.l2_normalize(J(feat[:, 0, 0])),
                                  jloss.l2_normalize(J(value[:, 0, 0])))), rtol=1e-6)


# --- lazy flow_up point evaluation ----------------------------------------

def test_composite_weights_match_jax():
    p = _pts(0)[..., 0]
    # same float32 formula (and the same f32-rounded align-corners step)
    np.testing.assert_allclose(_np(tfp.composite_weights_1d(T(p), WF, W)),
                               _np(jfp.composite_weights_1d(J(p), WF, W)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("is_norm", [False, True])
def test_advect_and_composed_flow_match_jax(is_norm):
    flows = _flows(2)
    grid = _grid_pts()
    # atol 1e-3, tests/test_flow_points.py: a 1-ulp position difference can
    # flip which side of a tent kink a trajectory samples, and composition
    # amplifies it for a handful of points
    np.testing.assert_allclose(_np(tfp.advect_up(T(flows), T(grid), is_norm)),
                               _np(jfp.advect_up(J(flows), J(grid), is_norm)),
                               rtol=1e-4, atol=1e-3)
    pts = _pts(4)
    np.testing.assert_allclose(_np(tfp.composed_flow_at(T(flows), T(pts), is_norm)),
                               _np(jfp.composed_flow_at(J(flows), J(pts), is_norm)),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("is_norm", [False, True])
def test_cycle_mask_matches_jax(is_norm):
    fwd, bwd = _flows(5), _flows(6)
    grid = _grid_pts()
    got = _np(tfp.cycle_mask_at(T(fwd), T(bwd), T(grid), A1, A2, is_norm))
    want = _np(jfp.cycle_mask_at(J(fwd), J(bwd), J(grid), A1, A2, is_norm))
    # boolean thresholds may flip right at the decision boundary under
    # float reassociation; tests/test_flow_points.py bounds it the same way
    assert (got == want).mean() > 0.995


def test_mask_ratio_estimate_matches_jax():
    fwd, bwd = _flows(18), _flows(19)
    got = _np(tfp.mask_ratio_estimate(T(fwd), T(bwd), A1, A2, stride=4))
    want = _np(jfp.mask_ratio_estimate(J(fwd), J(bwd), A1, A2, stride=4))
    # the estimate counts a few hundred points per sample: one flipped
    # boundary point moves it by 1/216
    np.testing.assert_allclose(got, want, atol=2.0 / 216)
    assert math.isfinite(float(got.mean()))
