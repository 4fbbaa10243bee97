"""The port's models held against the JAX package's, with the JAX weights
carried over by `flax_to_torch`: per-view BatchNorm, ResNet trunks, MLP2d,
and the PixPro loss and gradients. float32 on the CPU.

The trunks' zero-gamma init makes every residual branch output zero, which
would leave most convolutions untested, so the tests draw random BatchNorm
scales and biases before carrying the weights over."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.models import PixPro as JaxPixPro
from pixflow_tpu.models import init_momentum_from_online as jax_init_momentum
from pixflow_tpu.models.convert_pixpro import torch_pixpro_to_flax
from pixflow_tpu.models.heads import MLP2d as JaxMLP2d
from pixflow_tpu.models.norm import batch_norm as jax_batch_norm
from pixflow_tpu.models.resnet import make_resnet as jax_make_resnet
from pixflow_tpu.ops.flow_points import LazyFlowUp as JaxLazy

from pixflow_tpu_torch.models import MLP2d, PixPro, ViewBatchNorm, flax_to_torch, make_resnet
from pixflow_tpu_torch.ops.flow_points import LazyFlowUp

T = torch.tensor  # copies: JAX hands out read-only buffers


def _perturb_norms(params, seed):
    """Random BN scales in [0.5, 1.5] and biases ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for key, val in node.items():
            if hasattr(val, "items"):
                out[key] = walk(val)
            elif key == "scale":
                out[key] = jnp.asarray(rng.uniform(0.5, 1.5, val.shape).astype(np.float32))
            elif key == "bias" and val.ndim == 1:
                out[key] = jnp.asarray(0.1 * rng.standard_normal(val.shape).astype(np.float32))
            else:
                out[key] = val
        return out
    return walk(params)


def _state_dict(branch, params, stats):
    """flax_to_torch for a bare module: carry it as `branch` and strip it."""
    sd = flax_to_torch({branch: params}, {branch: stats} if stats else {})
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("groups", [1, 2])
def test_view_batch_norm_matches_jax(groups):
    rng = np.random.default_rng(groups)
    x = (3 + 2 * rng.standard_normal((4, 3, 5, 6))).astype(np.float32)
    bn = jax_batch_norm(view_groups=groups, use_running_average=False, momentum=0.9)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturb_norms(dict(variables["params"]), 3)
    stats = {"mean": jnp.full((6,), 0.5), "var": jnp.full((6,), 2.0)}
    want, mut = bn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         mutable=["batch_stats"])

    tbn = ViewBatchNorm(6, view_groups=groups, momentum=0.9)
    tbn.load_state_dict(_state_dict("bn", params, stats))
    got = tbn(T(x))
    # f32 means over 30-60 values per group, summed in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # running stats: biased variance, flax momentum, view 0 first
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]), rtol=1e-5)

    # eval mode: running averages
    ev = jax_batch_norm(view_groups=groups, use_running_average=True, momentum=0.9)
    want_ev = ev.apply({"params": params, "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(tbn.eval()(T(x)).detach().numpy(), np.asarray(want_ev),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,groups", [("resnet18", 2), ("resnet50", 1)])
def test_resnet_forward_matches_jax(arch, groups):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jnet = jax_make_resnet(arch, head_type="early_return", view_groups=groups)
    variables = jax.jit(lambda a: jnet.init(jax.random.PRNGKey(1), a))(jnp.asarray(x))
    params = _perturb_norms(dict(variables["params"]), 5)
    want, mut = jax.jit(lambda p, s, a: jnet.apply(
        {"params": p, "batch_stats": s}, a, mutable=["batch_stats"]))(
            params, variables["batch_stats"], jnp.asarray(x))

    tnet = make_resnet(arch, view_groups=groups)
    tnet.load_state_dict(_state_dict("encoder", params, variables["batch_stats"]))
    got = tnet(T(x))
    assert got.shape == want.shape == (2, 2, 2, tnet.feature_dim)
    # f32 convolutions of two libraries through 8 or 16 blocks, whose last
    # BatchNorms see 4-8 values per channel at 64 px: those small groups
    # amplify rounding (ResNet-50 measures ~4e-4), so the whole map and the
    # running statistics are compared as tensors at 1e-3
    assert _rel_err(got.detach().numpy(), want) < 1e-3
    want_sd = _state_dict("encoder", params, mut["batch_stats"])
    for name, buf in tnet.named_buffers():
        assert _rel_err(buf.numpy(), want_sd[name].numpy()) < 1e-3, name


def test_mlp2d_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 3, 3, 16)).astype(np.float32)
    jm = JaxMLP2d(inner_dim=32, out_dim=8, view_groups=2)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params = _perturb_norms(dict(variables["params"]), 7)
    want, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                       jnp.asarray(x), mutable=["batch_stats"])
    tm = MLP2d(16, 32, 8, view_groups=2)
    tm.load_state_dict(_state_dict("projector", params, variables["batch_stats"]))
    # two libraries' f32 matrix products around a BatchNorm
    np.testing.assert_allclose(tm(T(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def _pixpro_pair(fuse_views=True):
    kw = dict(arch="resnet18", pixpro_p=2.0, pixpro_transform_layer=1,
              pixpro_pos_ratio=0.7, proj_inner_dim=64, proj_out_dim=32,
              fuse_views=fuse_views)
    jm = JaxPixPro(**kw)
    im = jnp.zeros((2, 64, 64, 3), jnp.float32)
    v_on = jm.init(jax.random.PRNGKey(0), im, method=jm.online, train=True)
    v_k = jm.init(jax.random.PRNGKey(0), im, method=jm.momentum_branch, train=True)
    params = jax_init_momentum({**dict(v_on["params"]), **dict(v_k["params"])})
    stats = {**dict(v_on["batch_stats"]), **dict(v_k["batch_stats"])}
    tm = PixPro(**kw)
    return jm, tm, params, stats


def _batch(seed):
    """Two crops of a 72 x 128 frame, K=2 flows of 9 x 16 (tests/test_e2e.py)."""
    rng = np.random.default_rng(seed)
    im1 = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    im2 = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    coords = []
    for _ in range(2):
        c = np.zeros((2, 10), np.float32)
        for i in range(2):
            w, h = int(rng.integers(60, 100)), int(rng.integers(36, 60))
            j, ii = int(rng.integers(0, 128 - w)), int(rng.integers(0, 72 - h))
            c[i] = [j / 127, ii / 71, (j + w - 1) / 127, (ii + h - 1) / 71,
                    j, ii, w, h, 128, 72]
        coords.append(c)
    fwd = (0.3 * rng.standard_normal((2, 2, 9, 16, 2))).astype(np.float32)  # [K,B,h,w,2]
    bwd = (-fwd[::-1] + 0.05 * rng.standard_normal(fwd.shape)).astype(np.float32)
    return im1, im2, coords[0], coords[1], fwd, bwd


def test_pixpro_loss_and_gradients_match_jax():
    jm, tm, params, stats = _pixpro_pair()
    params = _perturb_norms(params, 8)
    im1, im2, c1, c2, fwd, bwd = _batch(9)

    def jax_loss(p):
        (loss, st), _ = jm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(im1), jnp.asarray(im2),
            jnp.asarray(c1), jnp.asarray(c2),
            JaxLazy(flows=jnp.asarray(fwd), flows_rev=jnp.asarray(bwd), alpha1=0.01, alpha2=0.5),
            JaxLazy(flows=jnp.asarray(bwd), flows_rev=jnp.asarray(fwd), alpha1=0.01, alpha2=0.5),
            train=True, mutable=["batch_stats"])
        return loss, st

    (want_loss, want_st), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)

    tm.load_state_dict(flax_to_torch(params, stats))
    loss, st = tm(T(im1), T(im2), T(c1), T(c2),
                  LazyFlowUp(T(fwd), T(bwd), 0.01, 0.5), LazyFlowUp(T(bwd), T(fwd), 0.01, 0.5))
    loss.backward()

    # f32 forward through two ResNet-18 branches of two libraries
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    for key in ("pos_num_1", "pos_num_2"):  # geometry only: exact
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(want_st[key]))
    assert float(st["pos_num_1"].sum()) > 0
    want_sd = flax_to_torch(want_g, {})
    for name, p in tm.named_parameters():
        if name.split(".")[0].endswith("_k"):
            assert p.grad is None  # momentum branch: no gradient
            continue
        got_g, want = p.grad.numpy(), want_sd[name].numpy()
        # whole tensors agree to f32 backward-pass accuracy; the floor covers
        # gradients that are zero but for rounding (a bias ahead of a
        # BatchNorm, which removes it)
        err = np.linalg.norm(got_g - want)
        assert err <= 2e-3 * np.linalg.norm(want) + 1e-7 * np.sqrt(want.size), name


def test_flax_to_torch_round_trip_and_load():
    jm, tm, params, stats = _pixpro_pair()
    sd = flax_to_torch(params, stats)
    missing, unexpected = tm.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    back = torch_pixpro_to_flax(sd)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    want = flat({"params": params, "batch_stats": stats})
    got = flat(back)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
