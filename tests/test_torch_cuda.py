"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one. The file imports no JAX, so that it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import json
import math

import pytest
import torch

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.ops.kernels import (cycle_mask_points, cycle_mask_points_plain,
                                           flow_up_points, flow_up_points_plain,
                                           fused_pair_sums, pair_sums, pair_sums_backward,
                                           pair_sums_backward_plain, pair_sums_plain,
                                           grid_sample, point_sample, point_sample_plain)
from pixflow_tpu_torch.ops import resample
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


def test_train_on_the_card_from_files(dev, tmp_path):
    """`train` on the card from a tiny corpus (ResNet-18, 64 px, batch 2,
    three-frame videos with .pth flows): every kernel of the step runs, as
    often as the step says, and the checkpoint reloads on the card."""
    from pixflow_tpu_torch.data.synthetic import write_video_corpus
    from pixflow_tpu_torch.ops.kernels import KERNELS
    from pixflow_tpu_torch.train import build_trainer, train
    from pixflow_tpu_torch.utils import latest_checkpoint, load_checkpoint

    write_video_corpus(str(tmp_path / "corpus"), 3, frame_hw=(72, 128), seed=8, n_videos=4)
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.data_dir = str(tmp_path / "corpus" / "images")
    cfg.data.image_size, cfg.data.batch_size, cfg.data.n_frames = 64, 2, 3
    cfg.data.num_workers, cfg.data.worker_mode = 2, "process"
    cfg.model.arch = "resnet18"
    cfg.optim.epochs = 1
    cfg.runtime.output_dir = str(tmp_path / "out")
    cfg.runtime.print_freq = 2  # step 0 logged; step 1 the last of the epoch
    before = {k.__name__: k.launches for k in KERNELS}
    state = train(cfg, device=dev)
    launches = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
    assert state.step == 2
    assert launches == {"pair_sums": 4, "pair_sums_backward": 4, "point_sample": 0,
                        "flow_up_points": 4 + 4, "grid_sample": 0}
    with open(tmp_path / "out" / "log.txt") as f:
        assert f"kernel launches: {json.dumps(launches)}" in f.read()
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(math.isfinite(r["loss"]) and r["pos_num"] > 0 and r["peak_memory_mb"] > 0
               for r in recs)

    fresh = build_trainer(cfg, dev, steps_per_epoch=2).state
    restored, epoch, _ = load_checkpoint(latest_checkpoint(cfg.runtime.output_dir), fresh)
    assert epoch == 1 and (restored.step, restored.ema_k) == (2, 2)
    want, got = state.model.state_dict(), restored.model.state_dict()
    assert all(got[n].device.type == "cuda" and torch.equal(got[n], want[n]) for n in want)
    assert all(torch.equal(v, state.opt_state.momentum[n])
               for n, v in restored.opt_state.momentum.items())


# --- K2's grid-sample entry and the materialising flow path -----------------

# the composition's reads: a 1/8-res field read at its own pixels (without
# --flow_up), a full-res field read at its 921600 pixels (--flow_up); and a
# small field of three channels
GRID_SHAPES = [(64, 90, 160, 2, (90, 160)), (64, 720, 1280, 2, (720, 1280)),
               (3, 7, 9, 3, (5, 11))]


@pytest.mark.parametrize("b,h,w,c,grid_hw", GRID_SHAPES)
def test_grid_sample_kernel_equals_the_gather(dev, b, h, w, c, grid_hw):
    """In the gather's op order: the plain gather's bits, out-of-field taps
    included."""
    g = torch.Generator(device=dev).manual_seed(h)
    img = 3.0 * torch.randn(b, h, w, c, device=dev, generator=g)
    grid = 2.4 * torch.rand(b, *grid_hw, 2, device=dev, generator=g) - 1.2
    grid[0, 0, :3] = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [1e9, 0.0]], device=dev)
    before = grid_sample.launches
    got = grid_sample(img, grid)
    want = resample.grid_sample(img, grid)
    torch.cuda.synchronize()
    assert grid_sample.launches == before + 1
    assert got.shape == want.shape == (b, *grid_hw, c)
    assert torch.equal(got, want)


def test_grid_sample_rejects_what_the_kernel_does_not_take(dev):
    img = torch.randn(2, 9, 16, 2, device=dev)
    grid = torch.rand(2, 4, 5, 2, device=dev)
    with pytest.raises(ValueError):
        grid_sample(img.double(), grid)
    with pytest.raises(ValueError):
        grid_sample(img.transpose(1, 2), grid)
    with pytest.raises(ValueError):
        grid_sample(img, grid[:1].contiguous())
    with pytest.raises(ValueError):  # 4 bytes off the float2 alignment
        grid_sample(img, torch.rand(81, device=dev)[1:].reshape(2, 4, 5, 2))
    assert grid_sample(img, torch.empty(2, 0, 3, 2, device=dev)).shape == (2, 0, 3, 2)


def _step_runs(dev, cfg, seed):
    """One f32 step through the kernels and one through their plain
    versions, from the same weights and batch: (metrics, state dict,
    launches) for each."""
    import copy

    from pixflow_tpu_torch.models import init_momentum_from_online
    from pixflow_tpu_torch.ops.kernels import KERNELS
    from pixflow_tpu_torch.train import build_model, build_trainer, run_steps, to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batch = to_device(synthetic_batch(cfg, seed=seed, orig_hw=(96, 160)), dev)
    model = build_model(cfg, dev)
    init_momentum_from_online(model)
    out = []
    for plain in (False, True):
        tr = build_trainer(cfg, dev, 10, model=copy.deepcopy(model), plain_kernels=plain)
        before = {k.__name__: k.launches for k in KERNELS}
        tr = run_steps(cfg, [batch], 1, dev, trainer=tr)
        torch.cuda.synchronize()
        out.append((tr.history[0], tr.state.model.state_dict(),
                    {k.__name__: k.launches - before[k.__name__] for k in KERNELS}))
    torch.backends.cudnn.deterministic = False
    return out


def _small_cfg(**flow):
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.batch_size, cfg.data.image_size, cfg.data.n_frames = 2, 64, 4
    cfg.model.arch = "resnet18"
    cfg.runtime.compute_dtype = "float32"
    for k, v in flow.items():
        setattr(cfg.flow, k, v)
    return cfg


def test_multi_span_step_kernels_match_plain(dev):
    """The multi-span step (K = 3: six windows) through the kernels against
    its plain versions: 12 launches of each K1 kernel and 12 + 2
    flow_up_points (one a window and direction, two for the logged step's
    telemetry), none in the plain run; loss and positive pairs agree."""
    (mk, sk, lk), (mp, sp, lp) = _step_runs(dev, _small_cfg(use_flow_frames=True), seed=2)
    assert lk == {"pair_sums": 12, "pair_sums_backward": 12, "point_sample": 0,
                  "flow_up_points": 12 + 2, "grid_sample": 0}
    assert all(v == 0 for v in lp.values())
    assert math.isfinite(mk["loss"]) and mk["pos_num"] > 0
    assert abs(mk["loss"] - mp["loss"]) <= 1e-4 * abs(mp["loss"])
    for key in ("pos_num_1", "pos_num_2"):
        assert abs(mk[key] - mp[key]) <= 5e-3 * max(mp[key], 1.0)


@pytest.mark.parametrize("flow_up,use_flow_frames,reads", [
    (True, False, 3 + 3 + 2),        # K = 3 reads a direction, a mask read each
    (False, False, 3 + 3 + 2),
    (True, True, 2 * (2 * 2 + 3) + 2 * 6),  # spans 2 and 3 read; 6 windows' masks
])
def test_materializing_step_runs_through_k2(dev, flow_up, use_flow_frames, reads):
    """--no-flow_up_lazy (or composition at 1/8 resolution): every read of
    the composition and the cycle masks is a K2 grid-sample launch; the step
    through the kernels equals the plain one's positive pairs."""
    cfg = _small_cfg(flow_up=flow_up, flow_up_lazy=False, use_flow_frames=use_flow_frames)
    (mk, sk, lk), (mp, sp, lp) = _step_runs(dev, cfg, seed=3)
    assert lk["grid_sample"] == reads and lk["flow_up_points"] == 0
    assert all(v == 0 for v in lp.values())
    assert abs(mk["loss"] - mp["loss"]) <= 1e-4 * abs(mp["loss"])
    assert 0.0 <= mk["mask_ratio_fwd"] <= 0.5


# --- RAFT: the correlation lookup through K2's grid-sample entry ---------------

@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
def test_raft_lookup_through_the_kernel_equals_the_gather(dev, split, monkeypatch):
    """RAFT-small's lookup (radius 3) at 64 x 96 frames, batch 2, through
    the grid entry against `plain=True`: equal to the bit; with the level's
    leading axis forced into views of 50 rows, one launch a view."""
    from pixflow_tpu_torch.models.raft import build_corr_pyramid, lookup_corr
    from pixflow_tpu_torch.models.raft import corr as raft_corr

    g = torch.Generator(device=dev).manual_seed(5)
    f1, f2 = (torch.randn(2, 8, 12, 64, device=dev, generator=g) for _ in range(2))
    pyr = build_corr_pyramid(f1, f2)
    coords = resample.coords_grid(8, 12, device=dev)[None] \
        + 3 * torch.randn(2, 8, 12, 2, device=dev, generator=g)
    if split:
        monkeypatch.setattr(raft_corr, "MAX_VIEW_ELEMENTS", 50 * 98 + 1)
    before = grid_sample.launches
    got = lookup_corr(pyr, coords, 3)
    launched = grid_sample.launches - before
    want = lookup_corr(pyr, coords, 3, plain=True)
    torch.cuda.synchronize()
    assert grid_sample.launches - before == launched  # the plain route launches nothing
    assert launched == (4 * math.ceil(192 / 50) if split else 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("small", [True, False], ids=["small", "basic"])
def test_raft_through_the_kernel_equals_the_plain_route(dev, small):
    """RAFT at 64 x 96, batch 2, 3 iterations, seeded random weights, TF32
    and cuDNN's nondeterministic algorithms off: 4 grid-entry launches an
    iteration, none on the plain route; the flows equal to the bit."""
    from pixflow_tpu_torch.models.raft import seeded_raft

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    model = seeded_raft(small, seed=7).to(dev)
    g = torch.Generator(device=dev).manual_seed(8)
    frames = torch.randint(0, 256, (2, 2, 64, 96, 3), device=dev, generator=g,
                           dtype=torch.uint8)
    with torch.no_grad():
        before = grid_sample.launches
        got = model(frames[:, 0], frames[:, 1], iters=3)
        launched = grid_sample.launches - before
        want = model(frames[:, 0], frames[:, 1], iters=3, plain=True)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    assert launched == 4 * 3 and grid_sample.launches - before == launched
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- RAFT training: the grid entry's backward kernel ---------------------------

def _backward_cases(dev):
    """(name, grad_out, grid, img_shape): a RAFT-basic lookup level (9 x 9
    windows about centroids at level 1 of a 46 x 62 feature map, batch 2),
    and a general grid with two channels: points outside, on the borders,
    on texel centres, and 9 a row on one texel."""
    from pixflow_tpu_torch.models.raft.corr import window_grid

    g = torch.Generator(device=dev).manual_seed(20)
    h, w = 46, 62
    coords = resample.coords_grid(h, w, device=dev)[None] \
        + 4 * torch.randn(2, h, w, 2, device=dev, generator=g)
    grid = window_grid(coords.reshape(-1, 2), 4, 1, 23, 31)
    n = grid.shape[0]
    yield "raft_level", torch.randn(n, 9, 9, 1, device=dev, generator=g), grid, (n, 23, 31, 1)
    grid = torch.rand(3, 6, 9, 2, device=dev, generator=g) * 2.6 - 1.3
    grid[:, 0, :, 0] = -1.0
    grid[:, 1, :, 1] = 1.0
    grid[:, 2] = 2 * 3 / 6 - 1
    grid[:, 3, :, 0] = 2 * 2.25 / 6 - 1
    grid[:, 3, :, 1] = 2 * 1.5 / 4 - 1
    grid[:, 4] = 5.0
    yield "general", torch.randn(3, 6, 9, 2, device=dev, generator=g), grid, (3, 5, 7, 2)


def test_grid_sample_backward_kernel_matches_plain(dev):
    """Against `grid_sample_backward_plain` on the card (index_add_ with
    atomics there): each texel's terms summed in another order, so
    |diff| <= 2^-21 x the sum of the terms' magnitudes; the kernel's own
    sums are in a fixed order, so two runs are equal to the bit."""
    from pixflow_tpu_torch.ops.kernels import grid_sample_backward, grid_sample_backward_plain

    for name, go, grid, shape in _backward_cases(dev):
        before = grid_sample_backward.launches
        got = grid_sample_backward(go, grid, shape)
        again = grid_sample_backward(go, grid, shape)
        want = grid_sample_backward_plain(go, grid, shape)
        mag = grid_sample_backward_plain(go.abs(), grid, shape)
        torch.cuda.synchronize()
        assert grid_sample_backward.launches == before + 2, name
        assert torch.equal(got, again), name
        assert torch.all((got - want).abs() <= 2.0 ** -21 * mag), name
        assert float(mag.max()) > 0, name


def test_grid_sample_with_grad_on_the_card(dev):
    """The Function's forward is the grid entry, bit for bit; its backward
    is the backward kernel, once a read (a non-contiguous incoming gradient
    included); a grid that requires a gradient raises."""
    from pixflow_tpu_torch.ops.kernels import grid_sample_backward, grid_sample_with_grad

    g = torch.Generator(device=dev).manual_seed(21)
    img = torch.randn(4, 7, 9, 1, device=dev, generator=g, requires_grad=True)
    grid = torch.rand(4, 5, 5, 2, device=dev, generator=g) * 2.2 - 1.1
    out = grid_sample_with_grad(img, grid)
    assert torch.equal(out, grid_sample(img.detach(), grid))
    before = grid_sample_backward.launches
    wide = torch.randn(4, 5, 5, 3, device=dev, generator=g)
    (torch.cat([out, out.detach()], dim=-1) * wide[..., :2]).sum().backward()
    assert grid_sample_backward.launches == before + 1
    ref = img.detach().clone().requires_grad_()
    (resample.grid_sample(ref, grid) * wide[..., :1]).sum().backward()
    torch.testing.assert_close(img.grad, ref.grad, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="no gradient for the grid"):
        grid_sample_with_grad(img, grid.clone().requires_grad_())


def test_grid_sample_backward_rejects_what_the_kernel_does_not_take(dev):
    from pixflow_tpu_torch.ops.kernels import grid_sample_backward

    go = torch.zeros(2, 3, 3, 1, device=dev)
    grid = torch.zeros(2, 3, 3, 2, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        grid_sample_backward(go, grid, (2, 300, 300, 1))
    with pytest.raises(ValueError, match="float32"):
        grid_sample_backward(go.double(), grid, (2, 4, 4, 1))
    with pytest.raises(ValueError, match="shapes"):
        grid_sample_backward(go, grid, (3, 4, 4, 1))


def test_raft_small_train_step_through_the_kernels(dev):
    """One RAFT-small train step at 64 x 96, batch 2, 3 iterations: 12
    grid-entry launches forward and 12 backward, finite gradients that
    reach fnet, and the loss and every gradient within 1e-4 relative (norm)
    of the same step through the plain gather and its autograd (TF32 off,
    cuDNN deterministic)."""
    from pixflow_tpu_torch.models.raft import seeded_raft
    from pixflow_tpu_torch.ops.kernels import grid_sample_backward
    from pixflow_tpu_torch.train.raft_trainer import (make_raft_train_step,
                                                      raft_optimizer, raft_train_state)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    g = torch.Generator(device=dev).manual_seed(22)
    batch = {"img1": 255 * torch.rand(2, 64, 96, 3, device=dev, generator=g),
             "img2": 255 * torch.rand(2, 64, 96, 3, device=dev, generator=g),
             "flow": 3 * torch.randn(2, 64, 96, 2, device=dev, generator=g),
             "valid": torch.ones(2, 64, 96, device=dev)}
    runs = {}
    for plain in (False, True):
        model = seeded_raft(True, seed=23).to(dev)
        _, tx = raft_optimizer(4e-4, 100, 1e-4)
        state = raft_train_state(model, tx)
        grads = {}
        for n, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        before = (grid_sample.launches, grid_sample_backward.launches)
        _, m = make_raft_train_step(tx, iters=3, plain=plain)(state, batch)
        torch.cuda.synchronize()
        runs[plain] = (float(m["loss"]), grads, (grid_sample.launches - before[0],
                                                 grid_sample_backward.launches - before[1]))
    torch.backends.cudnn.deterministic = False
    (loss_k, grads_k, launches_k), (loss_p, grads_p, launches_p) = runs[False], runs[True]
    assert launches_k == (12, 12) and launches_p == (0, 0)
    assert abs(loss_k - loss_p) <= 1e-6 * abs(loss_p)
    assert float(grads_k["fnet.conv1.weight"].abs().max()) > 0
    # the biases ahead of an instance norm have a gradient of zero up to
    # rounding: a floor of 1e-8 of all gradients' norm
    total = math.sqrt(sum(float(gp.norm()) ** 2 for gp in grads_p.values()))
    for n, gk in grads_k.items():
        assert torch.isfinite(gk).all(), n
        gp = grads_p[n]
        assert float((gk - gp).norm()) <= 1e-4 * float(gp.norm()) + 1e-8 * total, n


def test_view_batch_norm_over_two_gloo_ranks_on_the_card(dev):
    """Two ranks on the one card, joined by gloo (NCCL refuses two ranks on
    one device), each normalising its rows of both view groups with the
    global statistics: output, gradients and running statistics equal one
    process's ViewBatchNorm on the whole batch on the card."""
    import numpy as np

    from pixflow_tpu_torch.models import ViewBatchNorm
    from torch_dist_worker import run_cases, spawn

    rng = np.random.default_rng(32)
    groups, world, local_b, c = 2, 2, 3, 16
    x = (3 + 2 * rng.standard_normal((groups * world * local_b, 4, 5, c))).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    state = {"weight": (1 + 0.2 * rng.standard_normal(c)).astype(np.float32),
             "bias": (0.3 * rng.standard_normal(c)).astype(np.float32),
             "running_mean": np.full(c, 0.5, np.float32),
             "running_var": np.full(c, 2.0, np.float32)}

    def local(a):  # rank r's rows of every view group
        g = a.reshape((groups, world, local_b) + a.shape[1:])
        return [g[:, r].reshape((groups * local_b,) + a.shape[1:]) for r in range(world)]

    ranks = spawn(run_cases, world, {"view_batch_norm": {
        "x": local(x), "ct": local(ct), "state": state, "device": "cuda:0"}},
        device="cuda:0")

    bn = ViewBatchNorm(c, view_groups=groups, momentum=0.9).to(dev)
    bn.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    xt = torch.tensor(x, device=dev, requires_grad=True)
    y = bn(xt)
    gx, gw, gb = torch.autograd.grad(torch.sum(y * torch.tensor(ct, device=dev)),
                                     [xt, bn.weight, bn.bias])

    def whole(key):
        parts = [r["view_batch_norm"]["autograd"][key].reshape(
            (groups, local_b) + x.shape[1:]) for r in ranks]
        return np.stack(parts, axis=1).reshape(x.shape)

    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(whole("y"), y.detach().cpu().numpy(), **tol)
    np.testing.assert_allclose(whole("gx"), gx.cpu().numpy(), **tol)
    # the weight and bias gradients are sums over the 240 rows of a channel,
    # which the ranks split and the card adds in another order: held at
    # 1e-5 of the sum of the terms' magnitudes (~100 float32 ulps)
    xhat = ((y - bn.bias) / bn.weight).detach().cpu().numpy()
    mags = {"gw": np.abs(ct * xhat).reshape(-1, c).sum(0),
            "gb": np.abs(ct).reshape(-1, c).sum(0)}
    for key, want in (("gw", gw), ("gb", gb)):
        got = sum(r["view_batch_norm"]["autograd"][key] for r in ranks)
        err = np.abs(got - want.cpu().numpy())
        assert (err <= 1e-5 * mags[key]).all(), (key, err, mags[key])
    for r in ranks:
        got = r["view_batch_norm"]["autograd"]
        np.testing.assert_allclose(got["mean"], bn.running_mean.cpu().numpy(), **tol)
        np.testing.assert_allclose(got["var"], bn.running_var.cpu().numpy(), **tol)
