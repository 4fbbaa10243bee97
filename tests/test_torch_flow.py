"""The port's materialising flow algebra (`pixflow_tpu_torch/ops/flow.py`,
`ops/resample.py`'s resize, upflow8 and dispatch) held against the JAX
package's jitted functions on the same numpy inputs, in float32 on the CPU.

Through the JAX package's jitted step, constant divisors are reciprocal
products and the tent contractions run as XLA dots; the port writes the
same op order out. What remains between the two is the summation inside a
dot (a fused multiply-add or not), which composition then amplifies: the
tolerances below are stated per test, and masks are compared as the count
of pixels that differ."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.ops import flow as jflow
from pixflow_tpu.ops import resample as jres

from pixflow_tpu_torch.ops import flow as tflow
from pixflow_tpu_torch.ops import resample as tres
from pixflow_tpu_torch.ops.kernels import grid_sample as k2_grid_sample

from torch_threads import cap_torch_threads

cap_torch_threads()

H, W = 6, 9          # coarse field -> fine 48 x 72 (tests/test_flow_points.py)
B = 2
A1, A2 = 0.01, 0.5


def _flows(seed, k, h=H, w=W, scale=1.5):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((k, B, h, w, 2))).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.cache
def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def test_upflow8_and_resize_match_jax():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    img = rng.standard_normal((B, 5, 7, 3)).astype(np.float32)
    up = _np(tres.upflow8(torch.tensor(f)))
    assert up.shape == (B, 8 * H, 8 * W, 2)
    # two float32 products with two nonzeros a row: an FMA in either dot
    # moves the last bit
    np.testing.assert_allclose(up, _np(jax.jit(jres.upflow8)(f)), rtol=1e-6, atol=1e-6)
    for size in ((11, 4), (5, 7), (1, 13)):
        want = jax.jit(jres.resize_align_corners, static_argnums=1)(img, size)
        np.testing.assert_allclose(_np(tres.resize_align_corners(torch.tensor(img), size)),
                                   _np(want), rtol=1e-6, atol=1e-6, err_msg=str(size))
    np.testing.assert_array_equal(tres._interp_matrix_np(9, 72), jres._interp_matrix_np(9, 72))


@pytest.mark.parametrize("n,field,path", [
    (4096, (9, 16), "tent"),        # many points over a small field
    (4095, (9, 16), "gather"),      # one point short of the threshold
    (4096, (205, 200), "gather"),   # a field above 40960 pixels
])
def test_grid_sample_auto_dispatches_and_matches_jax(n, field, path):
    rng = np.random.default_rng(n + field[0])
    img = rng.standard_normal((B,) + field + (2,)).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (B, n, 1, 2)).astype(np.float32)
    got = tres.grid_sample_auto(torch.tensor(img), torch.tensor(grid))
    # the port's dispatch picks the same form as the JAX package's
    form = tres.grid_sample_tent if path == "tent" else tres.grid_sample
    np.testing.assert_array_equal(_np(got), _np(form(torch.tensor(img), torch.tensor(grid))))
    # K2's grid-sample entry takes the plain dispatch on the CPU
    np.testing.assert_array_equal(_np(k2_grid_sample(torch.tensor(img), torch.tensor(grid))),
                                  _np(got))
    want = jax.jit(jres.grid_sample_auto)(img, grid)
    # XLA's CPU code contracts a product and an add into one fused
    # multiply-add (see the next test), also in `(g + 1) * 0.5 * (w - 1)`:
    # a position one float32 ulp away (1.5e-5 px at x ~ 200) times the
    # unit-normal field's slope
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


def test_normalization_matches_jitted_jax():
    """Constant divisors: the port's reciprocal products give the jitted
    JAX functions' bits (true division would differ), except that XLA's CPU
    code fuses normalize_coords' product and `- 1` into one FMA, which the
    port's separate ops round twice: one float32 ulp of the product at most
(values in [-1, 1]: 1.2e-7 below 1, 2.4e-7 up to 2)."""
    rng = np.random.default_rng(3)
    c = rng.uniform(-5, 1300, (64, 2)).astype(np.float32)
    jit = lambda f: np.asarray(jax.jit(f, static_argnums=(1, 2))(c, 720, 1280))
    got = lambda f: _np(f(torch.tensor(c), 720, 1280))
    for tf, jf in ((tres.normalize_flow, jres.normalize_flow),
                   (tres.denormalize_flow, jres.denormalize_flow)):
        np.testing.assert_array_equal(got(tf), jit(jf))
    true_div = 2.0 * c[:, 0] / np.float32(1279)
    assert (true_div != jit(jres.normalize_flow)[:, 0]).any()
    want = jit(jres.normalize_coords)
    np.testing.assert_allclose(got(tres.normalize_coords), want, rtol=0, atol=2.4e-7)


# composed flows, pixels: the JAX package's own lazy-vs-materialising bound
# (tests/test_flow_points.py, rtol 1e-4, atol 1e-3 px). A position one ulp
# away can land on the other side of a tap and composition amplifies it, so
# a few elements (at most 0.05%) may exceed it, none by more than 10x.
FLOW_RTOL, FLOW_ATOL, OUTLIER_SHARE = 1e-4, 1e-3, 5e-4


def _assert_flows_close(got, want, unit=1.0):
    """`unit`: normalized units per pixel, for flows composed normalized."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want)
    allowed = FLOW_RTOL * np.abs(want) + FLOW_ATOL * unit
    over = int((err > allowed).sum())
    assert over <= OUTLIER_SHARE * err.size, f"{over} of {err.size} beyond tolerance"
    assert (err <= 10 * allowed).all(), float(err.max())


@pytest.mark.parametrize("upsample8", [False, True])
@pytest.mark.parametrize("is_norm", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_concat_flow_matches_jax(k, is_norm, upsample8):
    flows = _flows(10 + k, k)
    got = tflow.concat_flow(torch.tensor(flows), is_norm, upsample8)
    want = _jit(jflow.concat_flow, is_norm=is_norm, upsample8=upsample8)(flows)
    assert got.shape == want.shape
    if k == 1:  # no read: the (upsampled, normalized) flow itself
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    else:
        _assert_flows_close(got, want, 2.0 / (got.shape[2] - 1) if is_norm else 1.0)


@pytest.mark.parametrize("use_flow_frames", [False, True])
def test_all_concat_flow_matches_jax(use_flow_frames):
    fwd, bwd = _flows(20, 3), _flows(21, 3)
    got = tflow.all_concat_flow(torch.tensor(fwd), torch.tensor(bwd),
                                use_flow_frames=use_flow_frames)
    want = _jit(jflow.all_concat_flow, use_flow_frames=use_flow_frames)(fwd, bwd)
    assert got[0].shape == want[0].shape == ((6 if use_flow_frames else 1), B, H, W, 2)
    for g, w_ in zip(got, want):
        _assert_flows_close(g, w_)


def _mask_differ(got, want) -> int:
    return int((_np(got) != _np(want)).sum())


@pytest.mark.parametrize("is_norm", [False, True])
def test_forward_backward_consistency_matches_jax(is_norm):
    rng = np.random.default_rng(30)
    # a smooth field (an upsampled coarse one) and a noisy reverse: 83% trusted
    f = _np(tres.upflow8(torch.tensor(3.0 * rng.standard_normal((B, H, W, 2)),
                                      dtype=torch.float32))) / 8
    bk = (-f + 0.2 * rng.standard_normal(f.shape)).astype(np.float32)
    if is_norm:
        f, bk = (_np(jres.normalize_flow(x, 8 * H, 8 * W)) for x in (f, bk))
    got, got_cycle = tflow.forward_backward_consistency(
        torch.tensor(f), torch.tensor(bk), A1, A2, is_norm, return_cycle=True)
    want, want_cycle = _jit(jflow.forward_backward_consistency, alpha_1=A1, alpha_2=A2,
                            is_norm=is_norm, return_cycle=True)(f, bk)
    np.testing.assert_allclose(_np(got_cycle), _np(want_cycle), rtol=1e-5, atol=1e-5)
    # one read of the backward field, a few ulps apart: a decision at the
    # threshold may flip
    assert 0.2 < float(_np(want).mean()) < 0.98
    assert _mask_differ(got, want) <= 0.001 * got.numel(), _mask_differ(got, want)


@pytest.mark.parametrize("use_flow_frames", [False, True])
@pytest.mark.parametrize("flow_up", [False, True])
def test_compose_and_mask_matches_jax(flow_up, use_flow_frames):
    """The four modes of the train step's materialising path. Masks: pixels
    whose decision differs, at most 0.5% (the JAX package's own
    lazy-vs-materialising agreement, tests/test_flow_points.py)."""
    rng = np.random.default_rng(40)
    fwd = (1.5 * rng.standard_normal((B, 3, H, W, 2))).astype(np.float32)
    bwd = (-fwd[:, ::-1] + 0.3 * rng.standard_normal(fwd.shape)).astype(np.float32)
    got = tflow.compose_and_mask(torch.tensor(fwd), torch.tensor(bwd), flow_up=flow_up,
                                 use_flow_frames=use_flow_frames, alpha_1=A1, alpha_2=A2)
    want = _jit(jflow.compose_and_mask, flow_up=flow_up, use_flow_frames=use_flow_frames,
                alpha_1=A1, alpha_2=A2)(fwd, bwd)
    hw = (8 * H, 8 * W) if flow_up else (H, W)
    lead = (6, B) if use_flow_frames else (B,)
    for g, w_ in zip(got[:2], want[:2]):
        assert tuple(g.shape) == lead + hw + (2,) == tuple(w_.shape)
        _assert_flows_close(g, w_)
    for g, w_ in zip(got[2:], want[2:]):
        assert tuple(g.shape) == lead + hw and g.dtype == torch.bool
        assert _mask_differ(g, w_) <= 0.005 * g.numel(), _mask_differ(g, w_)
        assert 0.0 < float(_np(w_).mean()) < 1.0


def test_compose_and_mask_norm_mode_matches_jax():
    rng = np.random.default_rng(41)
    fwd = (1.5 * rng.standard_normal((B, 3, H, W, 2))).astype(np.float32)
    bwd = (-fwd[:, ::-1] + 0.3 * rng.standard_normal(fwd.shape)).astype(np.float32)
    got = tflow.compose_and_mask(torch.tensor(fwd), torch.tensor(bwd), flow_up=True,
                                 alpha_1=A1, alpha_2=A2, is_norm=True)
    want = _jit(jflow.compose_and_mask, flow_up=True, alpha_1=A1, alpha_2=A2,
                is_norm=True)(fwd, bwd)
    for g, w_ in zip(got[:2], want[:2]):
        _assert_flows_close(g, w_)
    for g, w_ in zip(got[2:], want[2:]):
        assert _mask_differ(g, w_) <= 0.005 * g.numel()


def test_compose_and_mask_without_alphas_has_no_masks():
    fwd = _flows(50, 2).transpose(1, 0, 2, 3, 4)
    out = tflow.compose_and_mask(torch.tensor(fwd), torch.tensor(fwd))
    assert out[2] is None and out[3] is None
    assert tflow.mask_ratio(None) is None


@pytest.mark.parametrize("k", [1, 3, 5])
def test_span_windows_and_mask_ratio(k):
    assert tflow.span_windows(k) == jflow.span_windows(k)
    assert len(tflow.span_windows(k)) == k * (k + 1) // 2
    m = np.random.default_rng(k).uniform(size=(k, B, 9, 16)) > 0.3
    np.testing.assert_allclose(_np(tflow.mask_ratio(torch.tensor(m))),
                               _np(jax.jit(jflow.mask_ratio)(m)), rtol=1e-6)


def test_span_one_windows_take_no_read():
    """A span-1 window is the flow itself (upsampled): no K2 read, so the
    K=1 composition does not depend on the sampler."""
    fwd = torch.tensor(_flows(60, 1))
    calls = []
    orig = tflow._sampler
    try:
        tflow._sampler = lambda plain: calls.append(plain) or orig(plain)
        out = tflow.concat_flow(fwd, upsample8=True)
    finally:
        tflow._sampler = orig
    assert calls == []
    np.testing.assert_array_equal(_np(out), _np(tres.upflow8(fwd[0])))
