"""The input pipeline: bucketed, padded, prefetched batches.

Port of the JAX package's ``data/loader.py``. A host thread assembles each
step's padded batch, in one of three ways (``DataLoader.assembler``):

* ``"native"``: the C++ assembler (``native/``), numpy out;
* ``"numpy"``: the same in numpy;
* ``"device_cache"``: the packed arrays are uploaded to the device once and
  each batch is gathered there (``DeviceCache``), tensors out.

The schedule is the JAX package's, item for item: the same numpy
generators (``default_rng``) drawn in the same order give the same buckets
and the same items for the same seed. The JAX package's loader also takes
a positional shard of it per process; the port runs one process, which
draws the whole schedule (multi-process training is ROADMAP.md Queue 1,
item 7). Features are served in the packed arrays' f16 (the step's cast to
f32 on the device gives the same values at half the bytes).
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from tacotron_tpu_torch.data.buckets import BucketSpec, assign_bucket, make_buckets
from tacotron_tpu_torch.data.vocab import Vocab
from tacotron_tpu_torch.runtime import resolve_device

PREFETCH = 2    # batches the loader's thread assembles ahead

@dataclass
class Batch:
    text: np.ndarray        # (B, text_len) int32, pad 0
    text_len: np.ndarray    # (B,) int32
    mel: np.ndarray         # (B, n_frames, n_mels) f16
    linear: np.ndarray      # (B, n_frames, n_freq) f16
    frame_len: np.ndarray   # (B,) int32
    bucket: int = 0
    items: tuple = ()       # dataset indices behind each row

    def arrays(self) -> tuple:
        return self.text, self.text_len, self.mel, self.linear, self.frame_len


class Dataset:
    """Packed-array dataset produced by ``ljspeech.preprocess`` (either
    package's), memory-mapped."""

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        with open(os.path.join(data_dir, "index.json")) as f:
            self.index = json.load(f)
        self.vocab = Vocab.load(os.path.join(data_dir, "vocab.json"))
        self.texts = np.load(os.path.join(data_dir, "texts.npy"), mmap_mode="r")
        self.mels = np.load(os.path.join(data_dir, "mels.npy"), mmap_mode="r")
        self.linears = np.load(os.path.join(data_dir, "linears.npy"), mmap_mode="r")

    def __len__(self):
        return len(self.index)

    def utterance(self, i: int):
        e = self.index[i]
        text = np.asarray(self.texts[e["text_offset"] : e["text_offset"] + e["text_len"]])
        mel = np.asarray(self.mels[e["frame_offset"] : e["frame_offset"] + e["n_frames"]],
                         dtype=np.float32)
        lin = np.asarray(self.linears[e["frame_offset"] : e["frame_offset"] + e["n_frames"]],
                         dtype=np.float32)
        return text, mel, lin


class DeviceCache:
    """The dataset on the device: the packed arrays are uploaded once, and
    each step's padded batch is gathered there, so a step moves only the
    rows' offsets and lengths (one (4, B) int64 upload) to the device.
    Features stay in the packed arrays' f16."""

    def __init__(self, dataset: Dataset, device=None):
        self.device = dev = resolve_device(device)
        need = dataset.texts.nbytes + dataset.mels.nbytes + dataset.linears.nbytes
        # a corpus that does not fit fails here with a clear message, not in
        # the allocator; the CPU has no such limit to read
        if dev.type == "cuda":
            _, limit = torch.cuda.mem_get_info(dev)
            if need > 0.9 * limit:
                raise ValueError(
                    f"DeviceCache: packed corpus needs ~{need / 2**30:.2f} GiB "
                    f"on device but the card reports {limit / 2**30:.2f} GiB "
                    f"of memory — the whole-corpus upload would not leave room "
                    f"for activations. Use the streaming loader "
                    f"(device_cache=False) for this corpus.")
        # np.array copies the read-only mmaps: torch must not alias them
        self.texts = torch.from_numpy(np.array(dataset.texts)).to(dev)
        self.mels = torch.from_numpy(np.array(dataset.mels)).to(dev)
        self.linears = torch.from_numpy(np.array(dataset.linears)).to(dev)
        idx = dataset.index
        self.t_off = np.asarray([e["text_offset"] for e in idx], np.int64)
        self.t_len = np.asarray([e["text_len"] for e in idx], np.int64)
        self.f_off = np.asarray([e["frame_offset"] for e in idx], np.int64)
        self.f_len = np.asarray([e["n_frames"] for e in idx], np.int64)

    def assemble(self, items, text_pad: int, frame_pad: int):
        """text, text_len, mel, linear, frame_len of these rows, on the
        device: each row's gather index clamped to its last element, the
        padding zeroed by a mask (pad id 0, zero frames)."""
        it = np.asarray(items, np.int64)
        meta = torch.from_numpy(np.stack([
            self.t_off[it], np.minimum(self.t_len[it], text_pad),
            self.f_off[it], np.minimum(self.f_len[it], frame_pad)])).to(self.device)
        t_off, t_len, f_off, f_len = meta
        dev = self.device
        ar_t = torch.arange(text_pad, device=dev)
        idx_t = t_off[:, None] + torch.minimum(ar_t[None, :], (t_len[:, None] - 1).clamp(min=0))
        text = (self.texts[idx_t.clamp(max=self.texts.shape[0] - 1)]
                * (ar_t[None, :] < t_len[:, None]))
        ar_f = torch.arange(frame_pad, device=dev)
        idx_f = f_off[:, None] + torch.minimum(ar_f[None, :], (f_len[:, None] - 1).clamp(min=0))
        mask_f = (ar_f[None, :] < f_len[:, None])[:, :, None]
        mel = self.mels[idx_f] * mask_f.to(self.mels.dtype)
        lin = self.linears[idx_f] * mask_f.to(self.linears.dtype)
        return (text.to(torch.int32), t_len.to(torch.int32), mel, lin,
                f_len.to(torch.int32))


class DataLoader:
    """Bucketed batches of ``batch_size`` over ``dataset``.

    ``use_native`` picks the C++ assembler (a failed build raises) over the
    numpy one; ``device_cache`` gathers batches on ``device`` (None: the
    card) instead, and ``device`` means nothing without it.
    ``self.assembler`` names the one in use."""

    def __init__(self, dataset: Dataset, batch_size: int, num_buckets: int, r: int,
                 seed: int = 0, use_native: bool = True, device_cache: bool = False,
                 device=None):
        self.ds = dataset
        self.batch_size = batch_size
        self.r = r
        self.cache = self.native = None
        if device_cache:
            self.cache = DeviceCache(dataset, device)
            self.assembler = "device_cache"
        elif use_native:
            from tacotron_tpu_torch.native import NativeBatcher

            self.native = NativeBatcher(dataset)
            self.assembler = "native"
        else:
            self.assembler = "numpy"
        text_lens = [e["text_len"] for e in dataset.index]
        frame_lens = [e["n_frames"] for e in dataset.index]
        self.buckets = make_buckets(text_lens, frame_lens, num_buckets, r)
        if not self.buckets:  # degenerate tiny datasets
            self.buckets = [BucketSpec(
                text_len=max(text_lens), n_frames=((max(frame_lens) + r - 1) // r) * r
            )]
        # each utterance in the smallest bucket that fits; one that fits none
        # is dropped
        self.assignments = {}
        for i, e in enumerate(dataset.index):
            b = assign_bucket(self.buckets, e["text_len"], e["n_frames"])
            if b >= 0:
                self.assignments.setdefault(b, []).append(i)
        self.assignments = {b: np.asarray(v) for b, v in self.assignments.items()}
        # TWO generators, as the JAX package draws them: the schedule rng
        # (the per-bucket shuffles and the step -> bucket sequence; in JAX
        # shared by every process) and the fill rng (wrap-fill items within
        # the bucket; in JAX seeded seed + process index)
        self.sched_rng = np.random.default_rng(seed)
        self.rng = np.random.default_rng(seed)

    def _make_batch(self, bucket_id: int, items: list[int]) -> Batch:
        spec = self.buckets[bucket_id]
        if self.cache is not None:
            return Batch(*self.cache.assemble(items, spec.text_len, spec.n_frames),
                         bucket=bucket_id, items=tuple(items))
        if self.native is not None:
            return Batch(*self.native.assemble(items, spec.text_len, spec.n_frames),
                         bucket=bucket_id, items=tuple(items))
        b = len(items)
        n_mels = self.ds.mels.shape[1]
        n_freq = self.ds.linears.shape[1]
        text = np.zeros((b, spec.text_len), np.int32)
        mel = np.zeros((b, spec.n_frames, n_mels), np.float16)
        lin = np.zeros((b, spec.n_frames, n_freq), np.float16)
        text_len = np.zeros((b,), np.int32)
        frame_len = np.zeros((b,), np.int32)
        for j, i in enumerate(items):
            t, m, l = self.ds.utterance(i)
            n_f = min(len(m), spec.n_frames)
            n_t = min(len(t), spec.text_len)
            text[j, :n_t] = t[:n_t]
            mel[j, :n_f] = m[:n_f]
            lin[j, :n_f] = l[:n_f]
            text_len[j] = n_t
            frame_len[j] = n_f
        return Batch(text, text_len, mel, lin, frame_len, bucket=bucket_id,
                     items=tuple(items))

    def epoch(self, shuffle: bool = True):
        """Yield full batches; within a batch all items share a bucket.

        Remainders are wrapped (sampled with replacement by the fill rng,
        within the bucket) to keep batches full."""
        order = {}
        for b, idx_all in self.assignments.items():
            idx = idx_all.copy()
            if shuffle:
                self.sched_rng.shuffle(idx)
            order[b] = idx
        pending = [(b, s) for b in order for s in range(-(-len(order[b]) // self.batch_size))]
        if shuffle:
            self.sched_rng.shuffle(pending)
        for b, s in pending:
            chunk = order[b][s * self.batch_size : (s + 1) * self.batch_size]
            if len(chunk) < self.batch_size:
                # fill from the bucket's own items, never across buckets,
                # which would truncate long utterances
                extra = self.rng.choice(order[b], self.batch_size - len(chunk))
                chunk = np.concatenate([chunk, extra])
            yield self._make_batch(b, list(chunk))

    def __iter__(self):
        """Infinite stream over reshuffled epochs, assembled ``PREFETCH``
        batches ahead by a thread. With the device cache the thread enqueues
        the gathers: they run on the device's default stream, the stream the
        training step runs on, so the step sees them done. An error in the
        thread is raised here; closing the stream stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                while not stop.is_set():
                    for batch in self.epoch(shuffle=True):
                        if not put(batch):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                put(_Failed(e))

        t = threading.Thread(target=worker, daemon=True, name="DataLoader")
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _Failed):
                    raise RuntimeError("the DataLoader's thread failed") from item.error
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


@dataclass
class _Failed:
    error: Exception


def put_batch(batch: Batch, device) -> tuple[tuple, tuple]:
    """-> (the batch's five arrays as tensors on ``device``, the pinned host
    tensors they are copied from). On a CUDA device each host array is
    pinned and copied with ``non_blocking=True`` on the current stream, the
    stream the step then runs on; keep the pinned tensors referenced until
    the step that reads the copies has been enqueued (``device_prefetch``'s
    pairs do). Tensors already on the device (the device cache's) pass
    through."""
    dev = torch.device(device)
    out, pinned = [], []
    for a in batch.arrays():
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
            pinned.append(t)
        out.append(t.to(dev, non_blocking=True))
    return tuple(out), tuple(pinned)


def device_prefetch(batch_iter, put_fn, depth: int = 2):
    """Overlap host->device copies with device compute.

    ``put_fn(batch)`` must enqueue its copies and return at once (as
    ``put_batch`` does); ``depth`` batches are kept in flight, so the step
    on batch N runs while batch N+1's bytes move. Yields (host batch,
    ``put_fn``'s result) pairs, in order; the tail is drained when
    ``batch_iter`` ends."""
    q: collections.deque = collections.deque()
    it = iter(batch_iter)
    try:
        while True:
            while len(q) < depth:
                b = next(it)
                q.append((b, put_fn(b)))
            yield q.popleft()
    except StopIteration:
        while q:
            yield q.popleft()
