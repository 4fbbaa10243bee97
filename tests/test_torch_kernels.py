"""The port's two kernels, held against the JAX package's Pallas kernels.

On the CPU the wrappers take the kernels' plain PyTorch versions, so these
tests pin the plain versions (the arithmetic the CUDA kernels are compared
with on the card) to `fused_pair_sums` / `tent_warp_pallas` run in Pallas
interpret mode and to the XLA compositions beside them. The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.ops import grid_sample as jax_grid_sample
from pixflow_tpu.ops import pixpro_pair_loss as jax_pair_loss
from pixflow_tpu.ops.flow_points import sample_up as jax_sample_up
from pixflow_tpu.ops.loss import l2_normalize as jax_l2n
from pixflow_tpu.ops.pallas.pair_loss import fused_pair_sums as jax_fused_pair_sums
from pixflow_tpu.ops.pallas.pair_loss import pixpro_pair_loss_fused as jax_pair_loss_fused
from pixflow_tpu.ops.pallas.warp import tent_warp_pallas

from pixflow_tpu_torch.ops.kernels import (pair_sums, pair_sums_plain, point_sample,
                                           point_sample_plain)
from pixflow_tpu_torch.ops.loss import pixpro_pair_loss_fused

T = torch.tensor  # copies: JAX hands out read-only buffers


def _coords(b, seed):
    r = np.random.default_rng(seed)
    out = np.zeros((b, 10), np.float32)
    for i in range(b):
        x, y = int(r.integers(0, 600)), int(r.integers(0, 300))
        w, h = int(r.integers(150, 600)), int(r.integers(150, 400))
        out[i] = [x / 1279, y / 719, (x + w - 1) / 1279, (y + h - 1) / 719,
                  x, y, w, h, 1280, 720]
    return out


def _unit(rng, shape):
    return np.asarray(jax_l2n(jnp.asarray(rng.standard_normal(shape).astype(np.float32))))


# --- K1 pair sums ---------------------------------------------------------

def _pair_inputs(seed, b=3, n=49, c=16, with_mask=True):
    rng = np.random.default_rng(seed)
    q = _unit(rng, (b, n, c))
    k = _unit(rng, (b, n, c))
    # centers spread over 400 px, bin diagonals of 40-90 px: a fair share
    # of the pairs lies within pos_ratio of the diagonal
    qx, qy, kx, ky = (rng.uniform(0, 400, (b, n)).astype(np.float32) for _ in range(4))
    inv_diag = (1.0 / rng.uniform(40, 90, b)).astype(np.float32)
    mask = (rng.random((b, n)) > 0.3).astype(np.float32) if with_mask else None
    return q, k, qx, qy, kx, ky, inv_diag, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_pair_sums_plain_matches_pallas_interpret(with_mask):
    args = _pair_inputs(1, with_mask=with_mask)
    want = np.asarray(jax_fused_pair_sums(
        *[None if a is None else jnp.asarray(a) for a in args], 0.7, True))
    got = pair_sums_plain(*[None if a is None else T(a) for a in args], 0.7).numpy()
    # the mask sum is an exact count; the logit sums differ by f32 summation order
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-5)
    assert want[:, 1].min() > 0


@pytest.mark.parametrize("with_flow", [False, True])
def test_fused_pair_loss_matches_jax(with_flow):
    """Loss-level parity, as tests/test_pair_loss_fused.py: the port's fused
    loss (K1 plain version on the CPU) against both JAX forms."""
    rng = np.random.default_rng(61)
    b, hw, c = 3, 7, 16
    q, k = _unit(rng, (b, hw, hw, c)), _unit(rng, (b, hw, hw, c))
    cq, ck = _coords(b, 1), _coords(b, 2)
    flow = mask = None
    if with_flow:
        flow = (15 * rng.standard_normal((b, 90, 160, 2))).astype(np.float32)
        mask = rng.random((b, 90, 160)) > 0.3
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else T(np.asarray(a))
    want_loss, (want_pn, _) = jax_pair_loss(j(q), j(k), j(cq), j(ck), 0.7,
                                            flow=j(flow), flow_mask=j(mask))
    fused_loss, (fused_pn, _) = jax_pair_loss_fused(
        j(q), j(k), j(cq), j(ck), 0.7, flow=j(flow), flow_mask=j(mask), interpret=True)
    got_loss, (got_pn, _) = pixpro_pair_loss_fused(t(q), t(k), t(cq), t(ck), 0.7,
                                                   flow=t(flow), flow_mask=t(mask))
    # tolerances of tests/test_pair_loss_fused.py
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(got_loss), float(fused_loss), rtol=1e-5)
    np.testing.assert_allclose(got_pn.numpy(), np.asarray(want_pn), rtol=1e-6)
    np.testing.assert_allclose(got_pn.numpy(), np.asarray(fused_pn), rtol=1e-6)


@pytest.mark.parametrize("with_flow", [False, True])
def test_fused_pair_loss_gradients_match_jax(with_flow):
    rng = np.random.default_rng(7)
    b, hw, c = 2, 7, 8
    q, k = _unit(rng, (b, hw, hw, c)), _unit(rng, (b, hw, hw, c))
    cq, ck = _coords(b, 3), _coords(b, 4)
    flow = mask = None
    if with_flow:  # brings pts_mask into the kernel
        flow = (15 * rng.standard_normal((b, 90, 160, 2))).astype(np.float32)
        mask = rng.random((b, 90, 160)) > 0.3
    j = lambda a: None if a is None else jnp.asarray(a)

    def jax_loss(q_, k_):
        return jax_pair_loss(q_, k_, j(cq), j(ck), 0.7, flow=j(flow), flow_mask=j(mask))[0]

    gq_ref, gk_ref = jax.grad(jax_loss, argnums=(0, 1))(j(q), j(k))
    qt, kt = T(q).requires_grad_(), T(k).requires_grad_()
    loss, _ = pixpro_pair_loss_fused(qt, kt, T(cq), T(ck), 0.7,
                                     flow=None if flow is None else T(flow),
                                     flow_mask=None if mask is None else T(mask))
    loss.backward()
    # tolerances of tests/test_pair_loss_fused.py
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq_ref), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_ref), rtol=1e-4, atol=1e-7)


def test_pair_sums_wrapper_on_cpu_takes_the_plain_version():
    args = [None if a is None else T(a) for a in _pair_inputs(2)]
    before = pair_sums.launches
    np.testing.assert_array_equal(pair_sums(*args, 0.7).numpy(),
                                  pair_sums_plain(*args, 0.7).numpy())
    assert pair_sums.launches == before  # only a kernel launch counts


# --- K2 point sampling ----------------------------------------------------

def test_point_sample_up1_matches_tent_warp_and_grid_sample():
    """As tests/test_pallas.py: the up=1 read is grid_sample at pixel points."""
    rng = np.random.default_rng(23)
    b, h, w, c = 2, 18, 24, 2
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(b, 20, 30, 2)).astype(np.float32)
    pts = np.stack([(grid[..., 0] + 1.0) * 0.5 * (w - 1),
                    (grid[..., 1] + 1.0) * 0.5 * (h - 1)], -1).reshape(b, -1, 2)
    want_gs = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid))).reshape(b, -1, c)
    want_tw = np.asarray(tent_warp_pallas(jnp.asarray(img), jnp.asarray(pts), interpret=True))
    got = point_sample(T(img), T(np.ascontiguousarray(pts)), up=1).numpy()
    np.testing.assert_allclose(got, want_gs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_tw, rtol=1e-5, atol=1e-5)


def test_point_sample_up1_point_api_and_padding():
    rng = np.random.default_rng(24)
    img = rng.standard_normal((1, 10, 12, 2)).astype(np.float32)
    pts = np.array([[[0, 0], [11, 9], [5.5, 4.5], [-3, 2], [20, 5],
                     [2.25, 7.75], [11, 0]]], np.float32)
    out = point_sample_plain(T(img), T(pts), up=1).numpy()
    want = np.asarray(tent_warp_pallas(jnp.asarray(img), jnp.asarray(pts),
                                       chunk=4, interpret=True))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[0, 0], img[0, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(out[0, 1], img[0, 9, 11], rtol=1e-6)
    np.testing.assert_allclose(out[0, 3], 0.0, atol=1e-7)  # out of bounds
    np.testing.assert_allclose(out[0, 4], 0.0, atol=1e-7)


def test_point_sample_up8_matches_sample_up():
    rng = np.random.default_rng(25)
    b, h, w = 2, 6, 9
    coarse = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    # continuous fine points, some outside the 48 x 72 fine grid
    pts = np.stack([rng.uniform(-3, 8 * w + 2, (b, 300)),
                    rng.uniform(-3, 8 * h + 2, (b, 300))], -1).astype(np.float32)
    want = np.asarray(jax_sample_up(jnp.asarray(coarse), jnp.asarray(pts)))
    got = point_sample(T(coarse), T(pts), up=8).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
