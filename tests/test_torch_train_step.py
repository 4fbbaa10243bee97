"""One float32 train step of the port matches the JAX
package's `make_train_step` on the same batch and weights (ResNet-18 PixPro
at 64 px, batch 2, fused views with per-view BatchNorm, K=2 flows of 9 x 16
for a 72 x 128 frame, lazy flow_up with the cycle mask, EMA, LARS): loss,
metrics, BatchNorm statistics, updated parameters and optimizer momentum."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixflow_tpu.models import PixPro as JaxPixPro
from pixflow_tpu.train import create_train_state as jax_create_state
from pixflow_tpu.train import frozen_momentum_branch_mask, make_train_step as jax_make_step
from pixflow_tpu.train import lars_sgd as jax_lars, warmup_cosine as jax_cosine

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.models import PixPro, flax_to_torch
from pixflow_tpu_torch.train import (create_train_state, frozen_momentum_branch_names,
                                     lars_sgd, make_train_step, synthetic_batch,
                                     warmup_cosine)

MODEL_KW = dict(arch="resnet18", pixpro_p=2.0, pixpro_transform_layer=1,
                pixpro_pos_ratio=0.7, proj_inner_dim=64, proj_out_dim=32,
                fuse_views=True)
STEP_KW = dict(ema_total_steps=50, ema_base_momentum=0.99, use_flow=True,
               flow_up=True, alpha1=0.01, alpha2=0.5)


def _norm_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want), np.linalg.norm(want)


@pytest.fixture(scope="module")
def one_step():
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe2")
    cfg.data.batch_size, cfg.data.image_size, cfg.data.n_frames = 2, 64, 3
    batch = synthetic_batch(cfg, seed=3, orig_hw=(72, 128))
    assert batch["flows_fwd"].shape == (2, 2, 9, 16, 2)

    # lr 1.0 at step 0 (no warmup) so the LARS update is well above rounding
    j_lr = jax_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    jm = JaxPixPro(**MODEL_KW)
    state = jax_create_state(jax.random.PRNGKey(0), jm, jax_lars(j_lr),
                             {"im1": jnp.zeros((1, 64, 64, 3))})
    j_tx = jax_lars(j_lr, weight_decay=1e-5,
                    frozen_mask=frozen_momentum_branch_mask(state.params))
    state = state.replace(opt_state=j_tx.init(state.params))
    j_step = jax_make_step(jm, j_tx, lr_schedule=j_lr, mesh=None, donate=False, **STEP_KW)
    j_new, j_metrics = j_step(state, {k: jnp.asarray(v) for k, v in batch.items()})

    model = PixPro(**MODEL_KW)
    model.load_state_dict(flax_to_torch(state.params, state.batch_stats))
    model = model.to(memory_format=torch.channels_last)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t_lr = warmup_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    tx = lars_sgd(t_lr, weight_decay=1e-5,
                  frozen=frozen_momentum_branch_names(dict(model.named_parameters())))
    t_state = create_train_state(model, tx, copy_online_to_momentum=False)
    step = make_train_step(tx, lr_schedule=t_lr, **STEP_KW)
    t_state, t_metrics = step(t_state, {k: torch.tensor(v) for k, v in batch.items()})
    return j_new, j_metrics, t_state, t_metrics, before


def test_metrics_match(one_step):
    j_new, jm, t_state, tm, _ = one_step
    assert set(tm) == set(jm)
    assert t_state.step == int(j_new.step) == 1 and t_state.ema_k == int(j_new.ema_k) == 1
    # f32 forward through two ResNet-18 branches of two libraries
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    # positive pairs depend on the geometry alone: exactly equal
    for key in ("pos_num_1", "pos_num_2", "pos_num", "pos_mean_1", "pos_mean_2", "pos_mean"):
        assert float(tm[key]) == float(jm[key]), key
    assert float(tm["pos_num"]) > 0
    for key in ("lr", "ema_momentum", "mask_ratio_fwd", "mask_ratio_bwd"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6, err_msg=key)


def test_batch_stats_match(one_step):
    j_new, _, t_state, _, _ = one_step
    want = flax_to_torch(j_new.params, j_new.batch_stats)
    for name, buf in t_state.model.named_buffers():
        err, ref = _norm_err(buf, want[name])
        # per-view BatchNorm over 4-8 values per channel in layer4 at 64 px
        # (see test_torch_models.py)
        assert err <= 1e-3 * ref + 1e-7, name


def test_updated_params_and_momentum_match(one_step):
    j_new, _, t_state, _, before = one_step
    want = flax_to_torch(j_new.params, {})
    want_mom = flax_to_torch(j_new.opt_state.momentum, {})
    n_moved = 0
    for name, p in t_state.model.named_parameters():
        old = before[name].numpy()
        d_got, d_want = p.detach().numpy() - old, want[name].numpy() - old
        if name.split(".")[0].endswith("_k"):
            # momentum branch: EMA of the pre-step online weights only
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
            np.testing.assert_array_equal(want_mom[name].numpy(), 0.0)
            assert name not in t_state.opt_state.momentum
            continue
        # the update (lr * LARS-scaled gradient) agrees as a tensor to f32
        # backward-pass accuracy, with a floor for rounding-level updates
        err, ref = _norm_err(d_got, d_want)
        assert err <= 2e-3 * ref + 1e-6 * np.sqrt(d_want.size), name
        err, ref = _norm_err(t_state.opt_state.momentum[name], want_mom[name])
        assert err <= 2e-3 * ref + 1e-6 * np.sqrt(d_want.size), name
        n_moved += ref > 0
    assert n_moved > 20


@pytest.mark.parametrize("kind", ["lars", "sgd"])
def test_optimizer_update_matches_jax(kind):
    """Three updates of LARS / SGD on a small tree with a frozen `_k` branch,
    1-D and matrix leaves, and a leaf that starts at zero (LARS leaves its
    first gradient unscaled: ||p|| = 0)."""
    from pixflow_tpu.train import sgd as jax_sgd
    from pixflow_tpu_torch.train import sgd

    rng = np.random.default_rng(0)
    shapes = {"enc.w": (4, 3, 2, 2), "enc.b": (4,), "head.w": (5, 4), "zero.w": (3, 3),
              "enc_k.w": (4, 3, 2, 2)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    params["zero.w"][:] = 0.0
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32) for n, v in params.items()}
             for _ in range(3)]
    lr = jax_cosine(0.5, epochs=4, warmup_epoch=1, steps_per_epoch=2)
    t_lr = warmup_cosine(0.5, epochs=4, warmup_epoch=1, steps_per_epoch=2)

    nest = lambda d: {"enc": {"w": d["enc.w"], "b": d["enc.b"]}, "head": {"w": d["head.w"]},
                      "zero": {"w": d["zero.w"]}, "enc_k": {"w": d["enc_k.w"]}}
    flat = lambda t: {f"{a}.{b}": np.asarray(v) for a, sub in t.items() for b, v in sub.items()}
    j_params = jax.tree.map(jnp.asarray, nest(params))
    mask = frozen_momentum_branch_mask(j_params)
    j_tx = (jax_lars(lr, weight_decay=1e-2, frozen_mask=mask) if kind == "lars"
            else jax_sgd(lr, weight_decay=1e-2, frozen_mask=mask))
    j_state = j_tx.init(j_params)
    for g in grads:
        upd, j_state = j_tx.update(jax.tree.map(jnp.asarray, nest(g)), j_state, j_params)
        j_params = jax.tree.map(lambda p, u: p + u, j_params, upd)

    t_params = {n: torch.tensor(v) for n, v in params.items()}
    frozen = frozen_momentum_branch_names(t_params)
    assert frozen == {"enc_k.w"}
    tx = (lars_sgd(t_lr, weight_decay=1e-2, frozen=frozen) if kind == "lars"
          else sgd(t_lr, weight_decay=1e-2, frozen=frozen))
    state = tx.init(t_params)
    for g in grads:
        tx.step_(state, t_params, {n: torch.tensor(v) for n, v in g.items()})

    assert state.count == 3 == int(j_state.count)
    want = flat(j_params)
    for n, p in t_params.items():
        # the same f32 arithmetic; norms and fused adds may round differently
        np.testing.assert_allclose(p.numpy(), want[n], rtol=1e-6, atol=1e-7, err_msg=n)
    np.testing.assert_array_equal(t_params["enc_k.w"].numpy(), params["enc_k.w"])
    want_mom = flat(j_state.momentum)
    for n, buf in state.momentum.items():
        np.testing.assert_allclose(buf.numpy(), want_mom[n], rtol=1e-5, atol=1e-7, err_msg=n)


def test_lr_and_ema_schedules_match_jax():
    from pixflow_tpu.models.pixpro import momentum_schedule as jax_momentum
    from pixflow_tpu.train import make_lr_schedule as jax_make_lr
    from pixflow_tpu_torch.models import momentum_schedule
    from pixflow_tpu_torch.train import make_lr_schedule

    for kind in ("cosine", "step"):
        args = (kind, 0.25, 200, 5, 68, 100.0, (120, 160, 180), 0.1)
        j, t = jax_make_lr(*args), make_lr_schedule(*args)
        for step in (0, 1, 339, 340, 341, 5000, 8159, 9000, 13599):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=2e-6,
                                       err_msg=f"{kind} step {step}")
    for k in (0, 1, 500, 135999):
        np.testing.assert_allclose(momentum_schedule(k, 136000, 0.99),
                                   float(jax_momentum(k, 136000, 0.99)), rtol=1e-7)
