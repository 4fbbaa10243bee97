"""K1's backward: the port's plain backward against the JAX package's custom
VJP of `fused_pair_sums` (Pallas in interpret mode), and the routing of
`fused_pair_sums` (no dk for a key that needs no gradient; one switch for
both plain halves). The CUDA backward kernel is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.ops.loss import l2_normalize as jax_l2n
from pixflow_tpu.ops.pallas.pair_loss import fused_pair_sums as jax_fused_pair_sums

from pixflow_tpu_torch.ops.kernels import (fused_pair_sums, pair_sums_backward,
                                           pair_sums_backward_plain)

# the module, which the package's function of the same name shadows
pair_sums_module = importlib.import_module("pixflow_tpu_torch.ops.kernels.pair_sums")
T = torch.tensor  # copies: JAX hands out read-only buffers


def _inputs(seed, b=3, n=49, c=16, with_mask=True):
    rng = np.random.default_rng(seed)
    unit = lambda shape: np.asarray(jax_l2n(jnp.asarray(
        rng.standard_normal(shape).astype(np.float32))))
    q, k = unit((b, n, c)), unit((b, n, c))
    # centers over 400 px, bin diagonals of 40-90 px: a fair share of the
    # pairs lies within pos_ratio of the diagonal
    qx, qy, kx, ky = (rng.uniform(0, 400, (b, n)).astype(np.float32) for _ in range(4))
    inv_diag = (1.0 / rng.uniform(40, 90, b)).astype(np.float32)
    mask = (rng.random((b, n)) > 0.3).astype(np.float32) if with_mask else None
    cot = rng.standard_normal((b, 2)).astype(np.float32)
    return (q, k, qx, qy, kx, ky, inv_diag, mask), cot


def _torch(args):
    return [None if a is None else T(a) for a in args]


@pytest.mark.parametrize("need_dk", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_pair_sums_backward_plain_matches_jax_vjp(with_mask, need_dk):
    args, cot = _inputs(11, with_mask=with_mask)
    geom = [None if a is None else jnp.asarray(a) for a in args[2:]]
    _, vjp = jax.vjp(lambda q, k: jax_fused_pair_sums(q, k, *geom, 0.7, True),
                     jnp.asarray(args[0]), jnp.asarray(args[1]))
    want_dq, want_dk = (np.asarray(t) for t in vjp(jnp.asarray(cot)))
    dq, dk = pair_sums_backward_plain(*_torch(args), T(cot)[:, 0], 0.7,
                                      need_dq=True, need_dk=need_dk)
    # the same f32 products, summed in another order
    np.testing.assert_allclose(dq.numpy(), want_dq, rtol=1e-5, atol=1e-7)
    if need_dk:
        np.testing.assert_allclose(dk.numpy(), want_dk, rtol=1e-5, atol=1e-7)
    else:
        assert dk is None
    assert np.abs(want_dq).max() > 0


def test_pair_sums_backward_computes_only_what_is_asked():
    args, cot = _inputs(12)
    g = T(cot)[:, 0]
    dq, dk = pair_sums_backward_plain(*_torch(args), g, 0.7, need_dq=False, need_dk=True)
    assert dq is None and dk.shape == (3, 49, 16)
    assert pair_sums_backward_plain(*_torch(args), g, 0.7, False, False) == (None, None)


def test_pair_sums_backward_wrapper_on_cpu_takes_the_plain_version():
    args, cot = _inputs(13)
    g = T(cot)[:, 0]  # a strided view, as autograd hands it over
    before = pair_sums_backward.launches
    got = pair_sums_backward(*_torch(args), g, 0.7)
    want = pair_sums_backward_plain(*_torch(args), g, 0.7)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert pair_sums_backward.launches == before  # only a kernel launch counts


@pytest.mark.parametrize("with_mask", [False, True])
def test_fused_pair_sums_without_key_gradient_returns_no_dk(with_mask):
    args, cot = _inputs(14, with_mask=with_mask)
    q_both, k_both = T(args[0]).requires_grad_(), T(args[1]).requires_grad_()
    fused_pair_sums(q_both, k_both, *_torch(args[2:]), 0.7).backward(T(cot))
    q_only, k_fixed = T(args[0]).requires_grad_(), T(args[1])
    fused_pair_sums(q_only, k_fixed, *_torch(args[2:]), 0.7).backward(T(cot))
    assert k_fixed.grad is None
    np.testing.assert_array_equal(q_only.grad.numpy(), q_both.grad.numpy())
    assert k_both.grad is not None


@pytest.mark.parametrize("plain", [False, True])
def test_fused_pair_sums_one_switch_selects_both_halves(monkeypatch, plain):
    """`plain=True` takes both plain versions; otherwise both wrappers (which
    on the card launch the kernels)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(pair_sums_module, name, wrapped)

    for name in ("pair_sums", "pair_sums_plain", "pair_sums_backward",
                 "pair_sums_backward_plain"):
        spy(name, getattr(pair_sums_module, name))
    args, cot = _inputs(15, b=2, n=9, c=8)
    q = T(args[0]).requires_grad_()
    pair_sums_module.fused_pair_sums(q, T(args[1]), *_torch(args[2:]), 0.7,
                                     plain=plain).backward(T(cot))
    if plain:
        assert calls == ["pair_sums_plain", "pair_sums_backward_plain"]
    else:
        # on CPU tensors each wrapper then calls its plain version itself
        assert calls == ["pair_sums", "pair_sums_plain", "pair_sums_backward",
                         "pair_sums_backward_plain"]
