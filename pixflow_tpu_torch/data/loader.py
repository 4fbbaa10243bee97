"""Host-sharded, prefetching batch loader.

Replaces the reference's DataLoader + DistributedSampler stack
(`contrast/data/__init__.py:70-85`): deterministic per-epoch shuffling keyed
on (seed, epoch) with wrap-around padding, per-host sharding (one JAX
process per host feeds its local slice of the global batch), and a
prefetch pipeline that decodes/augments ahead of the device step.

Topology invariance (stronger than DistributedSampler's interleaved
striding): the global batch sequence is a pure function of
(seed, epoch, global_batch_size) — host h of H feeds the contiguous rows
[h*bs, (h+1)*bs) of every global batch, which is exactly the slice that
`NamedSharding(mesh, P("data"))` places on host h's devices, and each
sample's augmentation rng is derived from (seed, epoch, dataset index)
only. An N-process run therefore assembles bit-identical global batches
(and identical per-device shards) to a 1-process N-device run — the
multi-process integration test (tests/test_multiprocess.py) pins this end
to end: discrete pair statistics exact, loss to float32 ulp noise.
Deliberate deviation from DistributedSampler: padding/truncation happens
at GLOBAL batch granularity, so steps_per_epoch (which feeds the LR
schedule and EMA ramp) is also topology-invariant — DistributedSampler's
per-rank ceil-padding can add an extra step on some host counts when the
dataset is ragged against the global batch.

Two worker models, selected by `worker_mode`:
  * 'thread'  — a thread pool inside the producer. Zero IPC cost, but JPEG
    decode under PIL holds the GIL for stretches; fine for tests and
    moderate step rates.
  * 'process' — forked decode workers (the reference DataLoader's
    `num_workers` model, `contrast/data/__init__.py:77-85`). Decode and
    augmentation run GIL-free in the children; samples return by pickle.
    Workers are forked lazily at first use, AFTER `init_cache`, so the
    byte cache is shared copy-on-write instead of duplicated.
Both modes consume the identical per-index RNG stream, so they produce
bit-identical batches (test-pinned).

The port's own copy of `pixflow_tpu/data/loader.py`, which gives the same
batches (`tests/test_torch_data.py` holds the two against each other). In
the port the trainer runs in the process that forks the workers, so the
pool initializer also limits each worker to one PyTorch thread, and
`start_workers` lets the driver fork the pool before it first touches CUDA;
the workers never do (decode, augmentation and `.pth` reads run on the
CPU). The Grain backend is not ported."""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .datasets import VideoFrameDataset, list_annotation_file, list_image_folder
from .transforms import get_transform

# Per-worker-process dataset, set inside each forked worker (including
# respawned replacements) by the Pool initializer below.
_FORK_DATASET = None


def _set_fork_dataset(dataset):
    """Pool initializer (runs inside each forked worker, incl. respawns).
    One PyTorch thread per worker: the workers together already fill the
    host's cores."""
    global _FORK_DATASET
    _FORK_DATASET = dataset
    torch.set_num_threads(1)


def _proc_fetch(args):
    idx, seed = args
    rng = random.Random(seed)
    return _FORK_DATASET.__getitem__(int(idx), rng)


class ShardedLoader:
    def __init__(self, dataset, global_batch_size: int, *,
                 num_hosts: int = 1, host_id: int = 0, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True,
                 num_threads: int = 4, prefetch: int = 2,
                 worker_mode: str = "thread"):
        assert global_batch_size % num_hosts == 0, \
            "global batch must divide evenly across hosts"
        assert worker_mode in ("thread", "process")
        self.dataset = dataset
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // num_hosts
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = max(num_threads, 1)
        self.prefetch = prefetch
        self.worker_mode = worker_mode
        self._pool = None

    def _process_pool(self):
        """Persistent forked worker pool (lazy, one per loader).

        The dataset reaches workers through the Pool *initializer* (under
        the fork start method the argument is inherited, not pickled), so
        replacement workers re-forked after a worker death get the right
        dataset too — and two live process-mode loaders never clobber each
        other through the module global."""
        if self._pool is None:
            import multiprocessing as mp
            ctx = mp.get_context("fork")
            self._pool = ctx.Pool(self.num_threads,
                                  initializer=_set_fork_dataset,
                                  initargs=(self.dataset,))
        return self._pool

    def start_workers(self):
        """Fork the process-mode workers now (a no-op for thread workers),
        e.g. before the caller initializes CUDA."""
        if self.worker_mode == "process":
            self._process_pool()

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        """Steps per epoch — a pure function of (n, global_batch_size),
        INDEPENDENT of host count (unlike DistributedSampler, whose
        per-rank ceil-padding can add an extra step on some topologies:
        n=7, G=4, 2 hosts pads each rank to 4 -> 2 steps, while 1 process
        does 7//4=1 — step counts feed the LR schedule, so that would
        silently change the training trajectory with the pod size).
        drop_last=True (every production caller + the reference,
        `contrast/data/__init__.py:85`) floors; drop_last=False ceils, with
        the final batch wrap-padded to full static shape."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch_size
        return int(np.ceil(n / self.global_batch_size))

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            g = np.random.default_rng(self.seed * 100003 + epoch)
            order = g.permutation(n)
        else:
            order = np.arange(n)
        # GLOBAL-batch blocking (see module docstring): truncate (drop_last)
        # or wrap-pad (else) the global order to steps*G rows, then host h
        # takes rows [h*bs, (h+1)*bs) of each global batch — exactly the
        # slice `NamedSharding(mesh, P("data"))` places on host h's devices,
        # so every topology consumes the identical global batch sequence
        total = len(self) * self.global_batch_size
        if total > n:  # wrap-around padding (drop_last=False only);
            # np.resize TILES the order, so a pad larger than the dataset
            # (n < G - n%G, e.g. 3 samples at global batch 8) still fills
            # the full static batch instead of underfilling
            order = np.resize(order, total)
        else:
            order = order[:total]
        if self.num_hosts == 1:
            return order
        return order.reshape(len(self), self.num_hosts,
                             self.local_batch_size)[:, self.host_id].reshape(-1)

    def epoch(self, epoch: int,
              skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate one epoch; skip_batches fast-forwards past the first N
        batches WITHOUT decoding them (indices and per-sample rngs are
        deterministic in (seed, epoch, index), so the remaining stream is
        bit-identical to an uninterrupted epoch — step-exact preemption
        resume)."""
        indices = self._epoch_indices(epoch)
        bs = self.local_batch_size
        n_batches = len(self)
        if skip_batches:
            indices = indices[skip_batches * bs:]
            n_batches = max(n_batches - skip_batches, 0)
        # host-independent per-sample rng: the same dataset index draws the
        # same augmentations no matter which host (or how many hosts) loads
        # it — required for the topology-invariance contract above
        base_seed = self.seed * 7919 + epoch * 104729

        def fetch(i):
            rng = random.Random(base_seed + int(i))
            return self.dataset.__getitem__(int(i), rng)

        if self.num_threads == 1 and self.worker_mode == "thread":
            for b in range(n_batches):
                chunk = indices[b * bs:(b + 1) * bs]
                yield _collate([fetch(i) for i in chunk])
            return

        # prefetch pipeline: a producer thread maps each batch's indices
        # over the worker pool (threads or forked processes)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def _batches_from(map_fn):
            for b in range(n_batches):
                if stop.is_set():
                    return
                chunk = indices[b * bs:(b + 1) * bs]
                if not _put(_collate(list(map_fn(chunk)))):
                    return

        def producer():
            try:
                if self.worker_mode == "process":
                    pool = self._process_pool()
                    _batches_from(lambda chunk: pool.map(
                        _proc_fetch,
                        [(int(i), base_seed + int(i)) for i in chunk]))
                else:
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(self.num_threads) as pool:
                        _batches_from(lambda chunk: pool.map(fetch, chunk))
            except BaseException as e:  # propagate worker failures
                error.append(e)
            finally:
                if not _put(None):
                    try:  # consumer already gone; sentinel is best-effort
                        out_q.put_nowait(None)
                    except queue.Full:
                        pass

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
            if error:
                raise error[0]
        finally:
            stop.set()


def _collate(samples) -> Dict[str, np.ndarray]:
    keys = [k for k, v in samples[0].items() if v is not None]
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def build_pretrain_loader(cfg, *, global_batch_size: Optional[int] = None,
                          num_hosts: int = 1, host_id: int = 0,
                          prefix: str = "train") -> ShardedLoader:
    """Assemble the pretrain loader from a PretrainConfig, resolving flow
    roots the way the reference does (`contrast/data/__init__.py:15-34`):
    default flow_root = dirname(data_dir)/flow/pth, then
    <flow_root>/<prefix>/{forward,backward}."""
    data, flow = cfg.data, cfg.flow

    transform = get_transform(data.aug, data.crop, data.image_size,
                              data.crop_ratio,
                              emit_uint8=getattr(data, "uint8_transfer", True),
                              device_photometric=getattr(data, "device_aug",
                                                         False))

    fwd_root = bwd_root = ""
    if flow.use_flow and flow.use_flow_file:
        flow_root = flow.flow_root
        if not flow_root:
            flow_root = os.path.join(os.path.dirname(data.data_dir.rstrip("/")),
                                     "flow", "pth")
        flow_root = os.path.join(flow_root, prefix)
        fwd_root = os.path.join(flow_root, flow.fwd_name or "forward")
        bwd_root = os.path.join(flow_root, flow.bwd_name or "backward")

    if data.ann_file:
        samples = list_annotation_file(
            os.path.join(data.data_dir, data.ann_file),
            img_prefix=os.path.join(data.data_dir, prefix + ".zip@/")
            if data.zip_mode else data.data_dir,
            dataset=data.dataset)
    else:
        samples = list_image_folder(os.path.join(data.data_dir, prefix),
                                    dataset=data.dataset)

    live_raft = flow.use_flow and not flow.use_flow_file
    dataset = VideoFrameDataset(
        samples=samples,
        transform=transform,
        n_frames=data.n_frames,
        two_crop=cfg.model.model in ("PixPro",),
        video_mode=data.dataset == "bdd100k",
        flow_fwd_root=fwd_root,
        flow_bwd_root=bwd_root,
        load_raw_frames=live_raft,
        use_flow_frames=flow.use_flow and flow.use_flow_frames
        and data.n_frames > 2,
        flow_dtype=getattr(data, "flow_transfer_dtype", "float16"),
        decode_scale=getattr(data, "decode_scale", 1),
        native_decode=getattr(data, "native_decode", False),
        restart_transcode=getattr(data, "restart_transcode", False),
    )

    # cfg.data.batch_size is per replica (reference: per GPU); the driver
    # passes the true global batch (= per-replica * n_devices).
    global_batch = global_batch_size or data.batch_size * num_hosts
    if getattr(data, "loader_backend", "native") == "grain":
        raise NotImplementedError(
            "--loader-backend grain is not ported (ROADMAP.md, Queue 1 item 4, "
            "data-parallel and multi-host)")
    return ShardedLoader(dataset, global_batch, num_hosts=num_hosts,
                         host_id=host_id, seed=cfg.runtime.seed,
                         num_threads=max(data.num_workers, 1),
                         worker_mode=getattr(data, "worker_mode", "thread"))
