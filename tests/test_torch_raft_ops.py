"""RAFT's pieces in the port against the JAX package's, on the CPU in
float32, on the same inputs made with numpy from a seed: the flow file
formats, `InputPadder` and `forward_interpolate`, the correlation pyramid
and its lookup (window order, the 1 x 1 guard, the split of a level's
leading axis), convex upsampling, the encoders in each norm, the update
blocks and both weight converters, with `load_raft`. JAX functions are
jitted once a module where a test reuses them. Cost: about 25 s on one
xdist worker (a dozen small XLA compiles)."""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixflow_tpu.data import flow_io as jax_flow_io
from pixflow_tpu.models.raft import corr as jax_corr
from pixflow_tpu.models.raft import extractor as jax_extractor
from pixflow_tpu.models.raft import update as jax_update
from pixflow_tpu.models.raft import utils as jax_utils
from pixflow_tpu.models.raft.convert import torch_state_dict_to_flax
from pixflow_tpu.models.raft.raft import convex_upsample_flow as jax_convex_up

from pixflow_tpu_torch.data import flow_io
from pixflow_tpu_torch.models.raft import (RAFT, build_corr_pyramid, convex_upsample_flow,
                                           load_raft, lookup_corr, raft_flax_to_torch)
from pixflow_tpu_torch.models.raft import corr as port_corr
from pixflow_tpu_torch.models.raft.extractor import Encoder
from pixflow_tpu_torch.models.raft.update import BasicUpdateBlock, SmallUpdateBlock
from pixflow_tpu_torch.models.raft.utils import InputPadder, forward_interpolate
from pixflow_tpu_torch.ops import resample

from torch_threads import cap_torch_threads

cap_torch_threads()


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def perturb_norms(module: torch.nn.Module, seed: int) -> None:
    """Random affine parameters and running statistics in every norm, so
    that the conversions of `scale`, `bias`, `mean` and `var` are held."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("running_mean") or name.endswith("bias") and t.dim() == 1 \
                    and "norm" in name:
                t.copy_(torch.from_numpy(rng.normal(0, 0.2, t.shape).astype(np.float32)))
            elif name.endswith("running_var") or name.endswith("weight") and t.dim() == 1:
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))


def to_flax(module: torch.nn.Module, small: bool):
    return torch_state_dict_to_flax(module.state_dict(), small=small)


# --- flow files ----------------------------------------------------------------

def test_flo_and_pfm_cross_read_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    flow = rng.standard_normal((6, 9, 2)).astype(np.float32)
    for writer, reader, name in ((flow_io.write_flo, jax_flow_io.read_flo, "a.flo"),
                                 (jax_flow_io.write_flo, flow_io.read_flo, "b.flo")):
        writer(str(tmp_path / name), flow)
        np.testing.assert_array_equal(reader(str(tmp_path / name)), flow)
    for img in (rng.standard_normal((5, 7)).astype(np.float32),
                rng.standard_normal((4, 6, 3)).astype(np.float32)):
        flow_io.write_pfm(str(tmp_path / "a.pfm"), img, scale=2.0)
        jax_flow_io.write_pfm(str(tmp_path / "b.pfm"), img, scale=2.0)
        for path in ("a.pfm", "b.pfm"):
            got, want = (flow_io.read_pfm(str(tmp_path / path)),
                         jax_flow_io.read_pfm(str(tmp_path / path)))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[0], img)
            assert got[1] == want[1] == 2.0
    np.testing.assert_array_equal(flow_io.read_flow_auto(str(tmp_path / "a.flo")), flow)
    np.save(tmp_path / "c.npy", flow)
    np.testing.assert_array_equal(flow_io.read_flow_auto(str(tmp_path / "c.npy")), flow)


def test_kitti_png_cross_reads_with_jax(tmp_path):
    """The port's PNG codec against the JAX package's OpenCV one, both ways,
    on a field with invalid pixels, and on a smooth field whose rows OpenCV
    writes with the Sub filter."""
    rng = np.random.default_rng(1)
    flow = (rng.standard_normal((13, 29, 2)) * 20).astype(np.float32)
    valid = rng.random((13, 29)) > 0.3
    yy, xx = np.mgrid[0:40, 0:77]
    smooth = np.stack([xx * 0.05, yy * -0.1], -1).astype(np.float32)
    for name, (f, v) in {"noisy": (flow, valid), "smooth": (smooth, None)}.items():
        flow_io.write_kitti_png(str(tmp_path / f"p_{name}.png"), f, v)
        jax_flow_io.write_kitti_png(str(tmp_path / f"j_{name}.png"), f, v)
        for path in (f"p_{name}.png", f"j_{name}.png"):
            got = flow_io.read_kitti_png(str(tmp_path / path))
            want = jax_flow_io.read_kitti_png(str(tmp_path / path))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(flow_io.read_flow_auto(str(tmp_path / f"j_{name}.png")), f,
                                   atol=1 / 64)


def _png_filter_row(kind, line, prev, bpp):
    """Encode one scanline with PNG filter `kind` (test-side encoder)."""
    line, prev = line.astype(np.int32), prev.astype(np.int32)
    out = np.zeros_like(line)
    for x in range(len(line)):
        a = line[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) // 2, None)[kind]
        if kind == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (line[x] - pred) & 0xFF
    return out.astype(np.uint8)


def test_png_reader_undoes_every_row_filter(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 2 ** 16, (10, 7, 3), dtype=np.uint16)
    lines = img.astype(">u2").view(np.uint8).reshape(10, 42)
    raw, prev = [], np.zeros(42, np.uint8)
    for y in range(10):
        kind = y % 5
        raw.append(np.concatenate([[kind], _png_filter_row(kind, lines[y], prev, 6)]))
        prev = lines[y]
    body = zlib.compress(np.concatenate(raw).astype(np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    path = tmp_path / "filters.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 10, 16, 2,
                                                                      0, 0, 0))
                     + chunk(b"IDAT", body) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(flow_io._read_png_rgb16(str(path)), img)
    flow, valid = jax_flow_io.read_kitti_png(str(path))
    np.testing.assert_array_equal(flow_io.read_kitti_png(str(path))[0], flow)


# --- utilities -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sintel", "kitti"])
def test_input_padder_matches_jax(mode):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 21, 30, 3)).astype(np.uint8)
    flow = rng.standard_normal((2, 21, 30, 2)).astype(np.float32)
    jp, tp = jax_utils.InputPadder(img.shape, mode), InputPadder(img.shape, mode)
    for x in (img, flow):
        (got,), (want,) = tp.pad(torch.from_numpy(x)), jp.pad(jnp.asarray(x))
        assert got.dtype == torch.from_numpy(x).dtype and got.shape == want.shape
        assert got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        np.testing.assert_array_equal(_np(tp.unpad(got)), x)


def test_forward_interpolate_matches_jax():
    flow = np.random.default_rng(4).standard_normal((12, 16, 2)).astype(np.float32) * 3
    np.testing.assert_array_equal(forward_interpolate(flow), jax_utils.forward_interpolate(flow))


# --- correlation pyramid and lookup --------------------------------------------

@pytest.fixture(scope="module")
def jax_corr_fns():
    pyramid = jax.jit(jax_corr.build_corr_pyramid)
    gather = jax.jit(jax_corr.lookup_corr_gather, static_argnums=2)
    tent = jax.jit(jax_corr.lookup_corr, static_argnums=2)
    return pyramid, gather, tent


def _fmaps_coords(b, h, w, c, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([xs, ys], -1).astype(np.float32)
    coords = base + spread * rng.standard_normal((b, h, w, 2)).astype(np.float32)
    return f1, f2, coords


def test_corr_pyramid_matches_jax(jax_corr_fns):
    f1, f2, _ = _fmaps_coords(2, 8, 12, 32, seed=5)
    want = jax_corr_fns[0](f1, f2)
    got = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    assert [tuple(t.shape) for t in got] == [(192, 8, 12, 1), (192, 4, 6, 1),
                                             (192, 2, 3, 1), (192, 1, 1, 1)]
    for g, w in zip(got, want):
        # a float32 dot product of 32 terms, summed in another order
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("radius", [3, 4])
def test_lookup_matches_the_jax_gather_and_tent_forms(jax_corr_fns, radius):
    """Against `lookup_corr_gather` (the same formulation: rounding-level
    differences only, from XLA's fused multiply-adds in the normalisation),
    and against the tent contractions that JAX's `lookup_corr` takes from
    256 points on (here 2 x 12 x 16 = 384): the tent form sums in another
    order, so it is held by tolerance and its differing elements are
    counted."""
    _, gather, tent = jax_corr_fns
    f1, f2, coords = _fmaps_coords(2, 12, 16, 16, seed=6)
    pyr = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    got = _np(lookup_corr(pyr, torch.from_numpy(coords), radius))
    jpyr = [jnp.asarray(_np(t)) for t in pyr]
    want_gather = np.asarray(gather(jpyr, coords, radius))
    want_tent = np.asarray(tent(jpyr, coords, radius))
    assert got.shape == want_gather.shape == (2, 12, 16, 4 * (2 * radius + 1) ** 2)
    # a position an ulp apart (~2e-6 px at 16 px) times a texel slope of a
    # few units
    np.testing.assert_allclose(got, want_gather, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_tent, rtol=1e-5, atol=1e-5)
    differ = int((got != want_tent).sum())
    # the two forms differ in the last bits of a share of the elements, and
    # agree exactly where a tap has weight 1 or every tap is outside
    assert 0 < differ < got.size, differ


def test_lookup_window_x_offset_is_the_slow_axis(jax_corr_fns):
    """On a pyramid that is a linear function of the target position,
    corr(y, x) = a x + b y, bilinear reads are exact: the window's channel
    i * (2r+1) + j must hold a (cx + off_i) + b (cy + off_j) at level 0,
    at non-integer centroids, as the JAX gather's does."""
    b, h, w, r = 1, 6, 8, 3
    win = 2 * r + 1
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    plane = (0.5 * xs + 3.0 * ys).astype(np.float32)
    level0 = np.broadcast_to(plane[None, :, :, None], (b * h * w, h, w, 1)).copy()
    coords = np.zeros((b, h, w, 2), np.float32)
    coords[..., 0], coords[..., 1] = 3.25, 2.5
    got = _np(lookup_corr([torch.from_numpy(level0)], torch.from_numpy(coords), r))
    off = np.arange(-r, r + 1, dtype=np.float32)
    px, py = 3.25 + off[:, None], 2.5 + off[None, :]
    inside = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    want = np.where(inside, 0.5 * px + 3.0 * py, np.nan).reshape(win * win)
    np.testing.assert_allclose(got[0, 0, 0][inside.reshape(-1)], want[inside.reshape(-1)],
                               rtol=1e-6)
    # the JAX gather's fused multiply-adds: an ulp of the window's values
    np.testing.assert_allclose(
        got, np.asarray(jax_corr_fns[1]([jnp.asarray(level0)], coords, r)),
        rtol=1e-6, atol=1e-6)


def test_lookup_one_texel_levels(jax_corr_fns):
    """A 4 x 4 feature map shrinks to 2 x 2, then 1 x 1 twice: a 1 x 1
    level gives its one texel at every window point, in range or not."""
    f1, f2, coords = _fmaps_coords(1, 4, 4, 8, seed=7, spread=6.0)
    pyr = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    assert [tuple(t.shape[1:3]) for t in pyr] == [(4, 4), (2, 2), (1, 1), (1, 1)]
    got = _np(lookup_corr(pyr, torch.from_numpy(coords), 3))
    want = np.asarray(jax_corr_fns[1]([jnp.asarray(_np(t)) for t in pyr], coords, 3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    texel = _np(pyr[2]).reshape(1, 4, 4, 1)
    np.testing.assert_array_equal(got[..., 2 * 49:3 * 49], np.broadcast_to(texel, (1, 4, 4, 49)))
    np.testing.assert_array_equal(got[..., 3 * 49:], got[..., 2 * 49:3 * 49])


def test_lookup_splits_the_leading_axis(monkeypatch):
    """A level's leading axis goes to the read in views below the kernel's
    32-bit element limit: forced small here, the split lookup equals the
    whole one to the bit, and each level is read once per view."""
    f1, f2, coords = _fmaps_coords(2, 8, 12, 16, seed=8)
    pyr = build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2))
    c = torch.from_numpy(coords)
    whole = lookup_corr(pyr, c, 4)
    reads = []
    plain_read = resample.grid_sample

    def counted(img, grid):
        reads.append(img.shape[0])
        return plain_read(img, grid)

    monkeypatch.setattr(resample, "grid_sample", counted)
    # level 0 holds 96 elements a row and its grid 162: 5 rows a view
    monkeypatch.setattr(port_corr, "MAX_VIEW_ELEMENTS", 5 * 162 + 7)
    split = lookup_corr(pyr, c, 4)
    assert torch.equal(split, whole)
    assert reads.count(5) == 4 * (192 // 5) and reads.count(192 % 5) == 4
    assert sum(reads) == 4 * 192


# --- convex upsampling, encoders, update blocks ---------------------------------

def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(9)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 576)).astype(np.float32)
    got = convex_upsample_flow(torch.from_numpy(flow), torch.from_numpy(mask))
    want = jax.jit(jax_convex_up)(flow, mask)
    assert got.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("small", [True, False], ids=["small", "basic"])
@pytest.mark.parametrize("norm", ["instance", "batch", "group", "none"])
def test_encoder_matches_jax(norm, small):
    torch.manual_seed(10)
    enc = Encoder(64, norm, small).eval()
    perturb_norms(enc, 11)
    x = np.random.default_rng(12).standard_normal((2, 32, 48, 3)).astype(np.float32)
    got = enc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    jenc = jax_extractor.Encoder(output_dim=64, norm_fn=norm, small=small)
    want = jax.jit(jenc.apply)(to_flax(enc, small), x)
    assert got.shape == want.shape == (2, 4, 6, 64)
    # float32 convolutions of two libraries through 13-14 layers
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("small", [True, False], ids=["small", "basic"])
def test_update_block_matches_jax(small):
    hdim, cdim, r = (96, 64, 3) if small else (128, 128, 4)
    corr_ch = 4 * (2 * r + 1) ** 2
    torch.manual_seed(13)
    blk = (SmallUpdateBlock if small else BasicUpdateBlock)(corr_ch, hdim, cdim)
    rng = np.random.default_rng(14)
    net, inp, corr, flow = (rng.standard_normal((2, 4, 6, c)).astype(np.float32)
                            for c in (hdim, cdim, corr_ch, 2))
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (net, inp, corr, flow)]
    g_net, g_mask, g_delta = blk(*nchw)
    jblk = (jax_update.SmallUpdateBlock if small else jax_update.BasicUpdateBlock)(
        corr_ch, hdim)
    variables = torch_state_dict_to_flax(blk.state_dict(), small=small)
    w_net, w_mask, w_delta = jax.jit(jblk.apply)(variables, net, inp, corr, flow)
    for g, w in ((g_net, w_net), (g_delta, w_delta)) + (() if small else ((g_mask, w_mask),)):
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
    assert (g_mask is None) == (w_mask is None) == small


# --- weights ---------------------------------------------------------------------

@pytest.mark.parametrize("small", [True, False], ids=["small", "basic"])
def test_converters_round_trip_exactly(small):
    model = RAFT(small, generator=torch.Generator().manual_seed(15))
    perturb_norms(model, 16)
    sd = model.state_dict()
    variables = torch_state_dict_to_flax(sd, small=small)
    back = raft_flax_to_torch(jax.tree_util.tree_map(np.asarray, variables), small)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    again = torch_state_dict_to_flax(back, small=small)
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    # the strided blocks' norms are also `downsample.1`, as in the reference
    ds = "norm4" if small else "norm3"
    assert "fnet.layer2.0.downsample.0.weight" in sd
    if not small:
        assert torch.equal(sd["cnet.layer2.0.downsample.1.running_var"],
                           sd[f"cnet.layer2.0.{ds}.running_var"])


def test_load_raft_reads_a_data_parallel_checkpoint(tmp_path):
    model = RAFT(False, generator=torch.Generator().manual_seed(17))
    perturb_norms(model, 18)
    path = str(tmp_path / "raft-things.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    loaded = load_raft(path, small=False)
    assert not loaded.training and not loaded.small
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    torch.save({f"module.{k}": v for k, v in RAFT(True).state_dict().items()},
               str(tmp_path / "raft-small.pth"))
    assert load_raft(str(tmp_path / "raft-small.pth"), small=True).small
    with pytest.raises(RuntimeError):  # a basic checkpoint is no small model
        load_raft(path, small=True)
