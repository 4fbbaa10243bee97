"""The port's data pipeline against the JAX package's, on the same corpus
and seed: every batch of an epoch bit-identical (thread and process
workers, skipped batches, one and two hosts), every augmentation recipe's
transforms drawing the same pixels and coordinates from the same
`random.Random`, `.npy` flows, flowpack shards read through the port's own
build of `native/flowpack.cpp`, and the loader's error propagation."""

import os
import random
import sys
import time

import numpy as np
import pytest
from PIL import Image

from pixflow_tpu.configs import PretrainConfig as JaxPretrainConfig
from pixflow_tpu.data import build_pretrain_loader as jax_build_loader
from pixflow_tpu.data import get_transform as jax_get_transform
from pixflow_tpu.data import VideoFrameDataset as JaxVideoFrameDataset
from pixflow_tpu.data import flowpack as jax_flowpack
from pixflow_tpu.data.datasets import frame_stats as jax_frame_stats

from pixflow_tpu_torch.configs import get_recipe
from pixflow_tpu_torch.data import (ShardedLoader, VideoFrameDataset, build_pretrain_loader,
                                    get_transform, list_image_folder)
from pixflow_tpu_torch.data import flowpack, native
from pixflow_tpu_torch.data.datasets import frame_stats, load_flow_file
from pixflow_tpu_torch.data.synthetic import write_video_corpus

from torch_threads import cap_torch_threads

cap_torch_threads()

# 8 six-frame videos and one of 3 frames, whose flow stack pads to K = 5
FRAMES = [6] * 8 + [3]
AUGS = ["NULL", "InstDisc", "MoCov2", "SimCLR", "BYOL", "RandAug", "val"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    write_video_corpus(str(root / "pth"), FRAMES, frame_hw=(72, 128), seed=3)
    write_video_corpus(str(root / "npy"), FRAMES, frame_hw=(72, 128), seed=3,
                       flow_format="npy")
    return root


def _cfg(data_dir, workers=2, worker_mode="thread"):
    cfg = get_recipe("pretrain_bdd100k_2000ep_nframe6")
    cfg.data.data_dir = data_dir
    cfg.data.image_size = 32
    cfg.data.num_workers = workers
    cfg.data.worker_mode = worker_mode
    cfg.runtime.seed = 5
    return cfg


def _assert_batches_equal(got_batches, want_batches):
    got_batches, want_batches = list(got_batches), list(want_batches)
    assert len(got_batches) == len(want_batches) > 0
    for got, want in zip(got_batches, want_batches):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1)], ids=["1host", "2hosts-h0", "2hosts-h1"])
@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_loader_batches_bit_identical_to_jax(corpus, worker_mode, skip, hosts):
    num_hosts, host_id = hosts
    cfg = _cfg(str(corpus / "pth" / "images"), worker_mode=worker_mode)
    jcfg = JaxPretrainConfig.from_json(cfg.to_json())
    loader = build_pretrain_loader(cfg, global_batch_size=4, num_hosts=num_hosts,
                                   host_id=host_id)
    jloader = jax_build_loader(jcfg, global_batch_size=4, num_hosts=num_hosts,
                               host_id=host_id)
    try:
        assert len(loader) == len(jloader) == len(FRAMES) // 4
        batches = list(loader.epoch(1, skip_batches=skip))
        _assert_batches_equal(batches, jloader.epoch(1, skip_batches=skip))
    finally:
        loader.close()
        jloader.close()
    assert len(batches) == len(loader) - skip
    b = batches[0]
    assert b["im1"].dtype == np.uint8 and b["im1"].shape == (4 // num_hosts, 32, 32, 3)
    assert b["flows_fwd"].dtype == np.float16
    assert b["flows_fwd"].shape == (4 // num_hosts, 5, 9, 16, 2)


def test_short_video_pads_its_flows(corpus):
    cfg = _cfg(str(corpus / "pth" / "images"), workers=1)
    loader = build_pretrain_loader(cfg, global_batch_size=1)
    short = len(FRAMES) - 1
    batch = next(b for b in loader.epoch(0) if int(b["index"][0]) == short)
    assert int(batch["n_frames_eff"][0]) == 3
    assert np.abs(batch["flows_fwd"][0, :2]).max() > 0
    assert np.array_equal(batch["flows_fwd"][0, 2:], np.zeros((3, 9, 16, 2), np.float16))
    assert np.array_equal(batch["flows_bwd"][0, 2:], np.zeros((3, 9, 16, 2), np.float16))
    loader.close()


def test_npy_flows_match_jax_and_pth(corpus):
    videos = list_image_folder(str(corpus / "npy" / "images" / "train"), "bdd100k")
    kw = dict(samples=videos, n_frames=6, two_crop=True, flow_ext=".npy",
              flow_fwd_root=str(corpus / "npy" / "flow" / "pth" / "train" / "forward"),
              flow_bwd_root=str(corpus / "npy" / "flow" / "pth" / "train" / "backward"))
    ds = VideoFrameDataset(transform=get_transform("BYOL", 0.08, 32), **kw)
    jds = JaxVideoFrameDataset(transform=jax_get_transform("BYOL", 0.08, 32), **kw)
    for i in range(len(videos)):
        got, want = ds.__getitem__(i, random.Random(i)), jds.__getitem__(i, random.Random(i))
        assert sorted(got) == sorted(want)
        for key in want:
            assert np.array_equal(got[key], want[key]), key
    # the same flows as the .pth corpus made from the same seed
    for v in (0, len(FRAMES) - 1):
        a, n_a = load_flow_file(str(corpus / "npy" / "flow" / "pth" / "train" / "forward"
                                    / f"video{v:03d}.npy"), 1, 3)
        b, n_b = load_flow_file(str(corpus / "pth" / "flow" / "pth" / "train" / "forward"
                                    / f"video{v:03d}.pth"), 1, 3)
        assert n_a == n_b == FRAMES[v] - 1 and np.array_equal(a, b)


@pytest.mark.parametrize("aug", AUGS)
def test_transforms_match_jax(aug):
    rng = np.random.default_rng(11)
    img = Image.fromarray(rng.integers(0, 256, (60, 90, 3), dtype=np.uint8))
    modes = [dict(emit_uint8=False), dict(emit_uint8=True)]
    if aug not in ("RandAug", "val"):
        modes.append(dict(device_photometric=True))
    for mode in modes:
        ts = get_transform(aug, 0.2, image_size=24, **mode)
        jts = jax_get_transform(aug, 0.2, image_size=24, **mode)
        pairs = zip(ts, jts) if isinstance(ts, tuple) else [(ts, jts)]
        for t, jt in pairs:
            for seed in range(6):
                got = t(img, random.Random(seed))
                want = jt(img, random.Random(seed))
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    if w is None:
                        assert g is None
                    else:
                        assert g.dtype == w.dtype and np.array_equal(g, w), (aug, mode, seed)


def test_flowpack_reads_match_jax_binding(corpus, tmp_path):
    flow_dir = str(corpus / "pth" / "flow" / "pth" / "train" / "forward")
    port_pack, jax_pack = str(tmp_path / "port.fpk"), str(tmp_path / "jax.fpk")
    flowpack.pack_flow_dir(flow_dir, port_pack)
    jax_flowpack.pack_flow_dir(flow_dir, jax_pack)
    with open(port_pack, "rb") as a, open(jax_pack, "rb") as b:
        assert a.read() == b.read()
    reader = flowpack.FlowPackReader(port_pack)
    jreader = jax_flowpack.FlowPackReader(jax_pack)
    assert len(reader) == len(jreader) == len(FRAMES)
    for v, n in enumerate(FRAMES):
        name = f"video{v:03d}"
        assert reader.num_flows(reader.find(name)) == n - 1
        for start, count in ((0, n - 1), (1, 1), (n - 2, 1)):
            got, want = reader.read(name, start, count), jreader.read(name, start, count)
            assert got.dtype == want.dtype == np.float16 and np.array_equal(got, want)
    with pytest.raises(IndexError):
        reader.read("video000", 4, 2)
    reader.close()
    jreader.close()
    # the port's library comes from its own build directory, not native/
    lib = flowpack._load_lib()
    assert os.path.dirname(os.path.dirname(lib._name)) == str(native.BUILD_DIR)


def _packed_corpus(corpus, tmp_path):
    """Flows as directories of flowpack shards, one per direction."""
    for name in ("forward", "backward"):
        flowpack.pack_flow_dir(str(corpus / "pth" / "flow" / "pth" / "train" / name),
                               str(tmp_path / "packs" / "train" / name), n_shards=2)
    cfg = _cfg(str(corpus / "pth" / "images"))
    cfg.flow.flow_root = str(tmp_path / "packs")
    return cfg


def test_flowpack_shards_through_loader_match_jax(corpus, tmp_path):
    cfg = _packed_corpus(corpus, tmp_path)
    # one worker on the JAX side: its loader threads can find the forward
    # pack reader open and the backward one not yet (the port publishes both
    # at once; see the stress test below)
    jcfg = JaxPretrainConfig.from_json(cfg.to_json())
    jcfg.data.num_workers = 1
    loader = build_pretrain_loader(cfg, global_batch_size=3)
    _assert_batches_equal(loader.epoch(2), jax_build_loader(jcfg, global_batch_size=3).epoch(2))
    loader.close()


def test_pack_readers_open_safely_under_thread_workers(corpus, tmp_path):
    """Many loader threads reach a fresh dataset's pack readers at once, with
    the interpreter switching threads as often as it can: every batch equals
    the one-thread loader's."""
    cfg = _packed_corpus(corpus, tmp_path)
    cfg.data.num_workers = 1
    want = list(build_pretrain_loader(cfg, global_batch_size=9).epoch(0))
    cfg.data.num_workers = 32
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        deadline = time.monotonic() + 10
        for _ in range(100):
            loader = build_pretrain_loader(cfg, global_batch_size=9)
            _assert_batches_equal(loader.epoch(0), want)
            if time.monotonic() > deadline:
                break
    finally:
        sys.setswitchinterval(interval)


def test_frame_stats_match_jax():
    n = np.array([1, 6, 6, 3, 2, 6])
    got, want = frame_stats(n, 6), jax_frame_stats(n, 6)
    assert got[:2] == want[:2] and np.array_equal(got[2], want[2])


def _failing_dataset(corpus, n_frames):
    videos = list_image_folder(str(corpus / "pth" / "images" / "train"), "bdd100k")
    return VideoFrameDataset(samples=videos, transform=get_transform("NULL", 0.2, 32),
                             n_frames=n_frames, two_crop=True,
                             flow_fwd_root="/nonexistent/fwd",
                             flow_bwd_root="/nonexistent/bwd")


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
def test_worker_errors_reach_the_consumer(corpus, worker_mode):
    """A failing sample fetch raises in the consumer; it does not hang."""
    loader = ShardedLoader(_failing_dataset(corpus, 3), 4, num_threads=2, prefetch=1,
                           worker_mode=worker_mode)
    loader.start_workers()
    try:
        with pytest.raises(FileNotFoundError):
            for _ in loader.epoch(0):
                pass
    finally:
        loader.close()


def test_grain_backend_is_not_ported(corpus):
    cfg = _cfg(str(corpus / "pth" / "images"))
    cfg.data.loader_backend = "grain"
    with pytest.raises(NotImplementedError, match="grain"):
        build_pretrain_loader(cfg, global_batch_size=2)
