"""Multi-span training (every (span, start) window of the frame stack) and
the materialising flow path of the port, held against the JAX package on
the same numpy inputs and weights, in float32 on the CPU (ResNet-18 PixPro
at 32 px, batch 4, n_frames 4: K = 3 flows of 9 x 16 for a 72 x 128 frame,
six windows):
- `PixPro.multi_span_loss` against the JAX package's, with ragged frame
  counts, fused and unfused views;
- the materialising single-span step against the lazy one.
One multi-span train step against the JAX package's is in
`tests/test_torch_multispan_step.py`.

The port's pair loss is K1's (`dist * inv_diag < r`), the JAX package's
multi-span loss the XLA form (`dist / max_diag < r`): a pair exactly at the
threshold could fall on either side. At these seeds the positive-pair
counts are equal; the tests say so by asserting it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixflow_tpu.models import PixPro as JaxPixPro
from pixflow_tpu.ops.flow import span_windows as jax_span_windows
from pixflow_tpu.ops.flow_points import LazyFlowUp as JaxLazyFlowUp
from pixflow_tpu.train import create_train_state as jax_create_state
from pixflow_tpu.train import frozen_momentum_branch_mask
from pixflow_tpu.train import lars_sgd as jax_lars, warmup_cosine as jax_cosine

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.models import PixPro, flax_to_torch
from pixflow_tpu_torch.ops.flow import span_windows
from pixflow_tpu_torch.ops.flow_points import LazyFlowUp
from pixflow_tpu_torch.train import (create_train_state, frozen_momentum_branch_names,
                                     lars_sgd, make_train_step, synthetic_batch,
                                     warmup_cosine)

from torch_threads import cap_torch_threads

cap_torch_threads()

HW, B, N_FRAMES = 32, 4, 4
N_EFF = np.array([4, 4, 3, 2], np.int32)  # ragged videos (tests/test_flow_frames.py)
MODEL_KW = dict(arch="resnet18", pixpro_p=2.0, pixpro_transform_layer=1,
                pixpro_pos_ratio=0.7, proj_inner_dim=64, proj_out_dim=32)
STEP_KW = dict(ema_total_steps=50, ema_base_momentum=0.99, use_flow=True,
               flow_up=True, use_flow_frames=True, alpha1=0.01, alpha2=0.5)


def _batch(seed=3):
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.batch_size, cfg.data.image_size, cfg.data.n_frames = B, HW, N_FRAMES
    cfg.flow.use_flow_frames = True
    batch = synthetic_batch(cfg, seed=seed, orig_hw=(72, 128))
    assert batch["ims1"].shape == (B, N_FRAMES - 1, HW, HW, 3)
    assert batch["flows_fwd"].shape == (B, N_FRAMES - 1, 9, 16, 2)
    batch["n_frames_eff"] = N_EFF.copy()
    return batch


def _jax_state(model):
    lr = jax_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
    state = jax_create_state(jax.random.PRNGKey(0), model, jax_lars(lr),
                             {"im1": jnp.zeros((1, HW, HW, 3))})
    tx = jax_lars(lr, weight_decay=1e-5, frozen_mask=frozen_momentum_branch_mask(state.params))
    return state.replace(opt_state=tx.init(state.params)), tx, lr


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want), np.linalg.norm(want)


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.mark.parametrize("fuse_views", [False, True])
def test_multi_span_loss_matches_jax(batch, fuse_views):
    jm = JaxPixPro(fuse_views=fuse_views, **MODEL_KW)
    state, _, _ = _jax_state(jm)
    f32 = lambda k: jnp.asarray(batch[k], jnp.float32)
    jfwd = jnp.transpose(f32("flows_fwd"), (1, 0, 2, 3, 4))
    jbwd = jnp.transpose(f32("flows_bwd"), (1, 0, 2, 3, 4))
    k = jfwd.shape[0]
    spans = jax_span_windows(k)
    assert span_windows(k) == spans

    def jax_loss(params, bs, ims1, ims2, c1, c2, fwd, bwd, n_eff):
        lf = lambda f, r: JaxLazyFlowUp(flows=f, flows_rev=r, alpha1=0.01, alpha2=0.5)
        wins = [(fwd[s:s + n], bwd[k - s - n:k - s]) for n, s in spans]
        (loss, stats), mut = jm.apply(
            {"params": params, "batch_stats": bs}, ims1, ims2, c1, c2,
            [lf(f, r) for f, r in wins], [lf(r, f) for f, r in wins], None, None,
            spans, n_eff, train=True, mutable=["batch_stats"], method=jm.multi_span_loss)
        return loss, stats, mut["batch_stats"]

    ims = lambda key: (jnp.asarray(batch[key], jnp.float32) - 128.0) / 64.0
    j_loss, j_stats, j_bs = jax.jit(jax_loss)(
        state.params, state.batch_stats, ims("ims1"), ims("ims2"), f32("coords1"),
        f32("coords2"), jfwd, jbwd, jnp.asarray(N_EFF))

    model = PixPro(fuse_views=fuse_views, **MODEL_KW)
    model.load_state_dict(flax_to_torch(state.params, state.batch_stats))
    model.train()
    t = lambda key: torch.tensor(np.asarray(batch[key], np.float32))
    fwd = t("flows_fwd").transpose(0, 1).contiguous()
    bwd = t("flows_bwd").transpose(0, 1).contiguous()
    wins = [(fwd[s:s + n], bwd[k - s - n:k - s]) for n, s in spans]
    lf = lambda f, r: LazyFlowUp(flows=f, flows_rev=r, alpha1=0.01, alpha2=0.5)
    loss, stats = model.multi_span_loss(
        (t("ims1") - 128.0) / 64.0, (t("ims2") - 128.0) / 64.0, t("coords1"), t("coords2"),
        [lf(f, r) for f, r in wins], [lf(r, f) for f, r in wins], None, None, spans,
        torch.tensor(N_EFF))

    # f32 forward through two ResNet-18 branches of two libraries; the loss
    # of these random weights is near 0 (-3.7e-4), hence the atol
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4, atol=1e-6)
    # per-sample statistics over each sample's valid windows (1-6 here);
    # the positive-pair counts are equal at this seed (K1's threshold form)
    for key in ("pos_num_1", "pos_num_2"):
        np.testing.assert_array_equal(stats[key].detach().numpy(), np.asarray(j_stats[key]))
    for key in ("pos_mean_1", "pos_mean_2"):
        np.testing.assert_allclose(stats[key].detach().numpy(), np.asarray(j_stats[key]),
                                   rtol=1e-6)
    assert float(stats["pos_num_1"].min()) > 0
    want_bs = flax_to_torch({}, j_bs)
    for name, buf in model.named_buffers():
        err, ref = _rel(buf, want_bs[name])
        assert err <= 1e-3 * ref + 1e-7, name


def test_materializing_single_span_step_matches_lazy():
    """The same single-span step on the same batch and weights, flows
    composed and masked as whole 72 x 128 fields, and lazily at the loss's
    points: the JAX package's own bounds between the two
    (tests/test_flow_points.py: loss rtol 1e-4, equal positive pairs)."""
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.batch_size, cfg.data.image_size, cfg.data.n_frames = B, HW, N_FRAMES
    batch = {k: torch.tensor(v) for k, v in synthetic_batch(cfg, seed=9, orig_hw=(72, 128)).items()}
    torch.manual_seed(0)
    model = PixPro(**MODEL_KW)
    results = []
    for lazy in (True, False):
        m = PixPro(**MODEL_KW)
        m.load_state_dict(model.state_dict())
        lr = warmup_cosine(1.0, epochs=10, warmup_epoch=0, steps_per_epoch=5)
        tx = lars_sgd(lr, weight_decay=1e-5,
                      frozen=frozen_momentum_branch_names(dict(m.named_parameters())))
        state = create_train_state(m, tx)
        kw = dict(STEP_KW, use_flow_frames=False)
        step = make_train_step(tx, lr_schedule=lr, flow_up_lazy=lazy, **kw)
        state, metrics = step(state, batch)
        results.append((metrics, state.model.state_dict()))
    (ml, sl), (mm, sm) = results
    np.testing.assert_allclose(float(mm["loss"]), float(ml["loss"]), rtol=1e-4, atol=1e-5)
    assert float(mm["pos_num"]) == float(ml["pos_num"]) > 0
    # the full field's ratio every step (the lazy step's is a 12-point
    # strided estimate at this size)
    for key in ("mask_ratio_fwd", "mask_ratio_bwd"):
        assert 0.0 < float(mm[key]) < 0.5, key
    for name, v in sm.items():
        if v.dtype.is_floating_point:
            err, ref = _rel(v, sl[name])
            assert err <= 1e-4 * ref + 1e-7, name
