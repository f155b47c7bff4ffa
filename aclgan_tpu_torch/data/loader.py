"""Host input pipeline: threaded decode/augment workers + device prefetch.

Port of `aclgan_tpu/data/loader.py`. A thread pool (PIL decode and numpy
release the GIL) fills a bounded set of ready NHWC batches, yielded in order;
`device_prefetch` keeps the next batches' host->device copies in flight on a
side CUDA stream. drop_last=True and shuffle=train, as the reference's torch
DataLoader. For the same config and seed the batches are byte-identical to
the JAX loader's, for any `num_workers`: every random draw comes from a
numpy generator keyed by (seed, epoch, batch), the synthetic datasets take
the same `zlib.crc32` seeds, and JPEGs take the same route: through the
libjpeg core (`data/native.py`, the same source and flags as the JAX
package's) when it builds, with the JAX loader's draws, and through Pillow
when it does not or with `use_native=False`.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import warnings
import zlib
from typing import Iterator, Optional, Sequence, Union

import numpy as np
import torch

from aclgan_tpu_torch.config import Config
from aclgan_tpu_torch.data.dataset import (list_images_filelist, list_images_folder,
                                           load_image, require_pillow)
from aclgan_tpu_torch.data.transforms import (TransformSpec, apply_transform,
                                              flip_left_right, normalize_batch)


class _Dataset:
    """Index -> decoded/augmented (H, W, 3) uint8 sample."""

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def get(self, index: int, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


class ImageDataset(_Dataset):
    """Image files decoded, flipped, resized and cropped. With `use_native`
    and the core built, JPEGs go through `data/native.py`; other files, and
    every file otherwise, through Pillow. Either route draws the flip first,
    so the augmentation stream stays deterministic per (seed, epoch, batch)."""

    def __init__(self, paths: Sequence[str], spec: TransformSpec,
                 use_native: bool = True):
        self.paths = list(paths)
        self.spec = spec
        self._warned = False
        self._native = None
        if use_native:
            from aclgan_tpu_torch.data import native

            self._native = native if native.available() else None

    @property
    def native(self) -> bool:
        """True when JPEGs decode through the native core."""
        return self._native is not None

    def __len__(self) -> int:
        return len(self.paths)

    def get(self, index: int, rng: np.random.Generator) -> np.ndarray:
        # corrupt/unreadable file: warn once, substitute the nearest readable
        # neighbour, scanning forward (a single retry would fail on two
        # adjacent bad files, or retry the same file of a 1-image dataset)
        last_exc: Optional[Exception] = None
        for off in range(len(self.paths)):
            i = (index + off) % len(self.paths)
            try:
                return self._get(i, rng)
            except Exception as exc:  # any decode failure of one file
                last_exc = exc
                if not self._warned:
                    warnings.warn(f"failed to load {self.paths[i]}: {exc}; "
                                  f"substituting a neighbor sample")
                    self._warned = True
        raise RuntimeError(f"every file in the dataset failed to load (last: {last_exc})")

    def _get(self, index: int, rng: np.random.Generator) -> np.ndarray:
        spec = self.spec
        # the flip is drawn before the file is read, as the JAX loader does,
        # so a substituted neighbour sees the same rng state there
        flip = bool(spec.flip and rng.random() < 0.5)
        path = self.paths[index]
        if self._native is not None and path.lower().endswith((".jpg", ".jpeg")):
            top_frac, left_frac = rng.random(), rng.random()
            with open(path, "rb") as f:
                data = f.read()
            out = self._native.decode_jpeg_augment(data, spec.new_size, spec.crop_h,
                                                   spec.crop_w, flip, top_frac, left_frac)
            if out is not None:
                return out
            # a failed decode (corrupt file, image smaller than the crop) goes
            # to Pillow on a generator seeded from the crop draw, as in JAX
            rng2 = np.random.default_rng([int(top_frac * 1e9)])
            return apply_transform(load_image(path), spec, rng2)
        img = load_image(path)
        if flip:
            img = flip_left_right(img)
        no_flip = TransformSpec(spec.new_size, spec.crop_h, spec.crop_w, False)
        return apply_transform(img, no_flip, rng)


class SyntheticDataset(_Dataset):
    """Procedural smooth-blob images; for smoke tests and benchmarking the
    compute path without a real dataset (no reference analog)."""

    def __init__(self, size: int, image_hw: tuple, seed: int = 0):
        self.size = size
        self.hw = image_hw
        self.seed = seed
        h, w = image_hw
        self._yy = np.arange(h, dtype=np.float32)[:, None]
        self._xx = np.arange(w, dtype=np.float32)[None, :]

    def __len__(self) -> int:
        return self.size

    def get(self, index: int, rng: np.random.Generator) -> np.ndarray:
        h, w = self.hw
        local = np.random.default_rng(self.seed * 1000003 + index)
        img = np.zeros((h, w, 3), np.float32)
        for _ in range(3):
            cy, cx = local.uniform(0, h), local.uniform(0, w)
            s = local.uniform(h / 8, h / 3)
            gy = np.exp(-np.square(self._yy - cy) / (2 * s * s))
            gx = np.exp(-np.square(self._xx - cx) / (2 * s * s))
            img += (gy * gx)[..., None] * local.uniform(0, 255, size=(3,)).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.uint8)


class DataLoader:
    """Epoch-shuffled, drop-last batch iterator with worker threads.

    `__iter__` yields NHWC numpy batches: float32 in [-1, 1] by default, or
    raw uint8 with `emit="uint8"` (the trainer maps them to [-1, 1] on the
    device). `iter_padded` (eval) and `first_n` (display batches) always
    yield normalized float32. Deterministic per (seed, epoch).
    """

    def __init__(self, dataset: _Dataset, batch_size: int, train: bool,
                 num_workers: int = 4, seed: int = 0, prefetch_batches: int = 4,
                 emit: str = "float32"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.num_workers = max(0, num_workers)
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.epoch = 0
        if emit not in ("float32", "uint8"):
            raise ValueError(f"emit must be 'float32' or 'uint8', got {emit!r}")
        self._finalize = (lambda b: b) if emit == "uint8" else normalize_batch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size  # drop_last

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.train:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx[:len(self) * self.batch_size]

    def _batch(self, epoch: int, bi: int, batch_idx: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch, bi))
        return self._finalize(np.stack([self.dataset.get(int(i), rng) for i in batch_idx]))

    def __iter__(self) -> Iterator[np.ndarray]:
        batches = self._epoch_indices().reshape(-1, self.batch_size)
        epoch = self.epoch
        self.epoch += 1

        if self.num_workers == 0:
            for bi, batch_idx in enumerate(batches):
                yield self._batch(epoch, bi, batch_idx)
            return

        out_q: "queue.Queue[int]" = queue.Queue()  # completion tokens
        stop = threading.Event()
        n_batches = len(batches)
        done: dict = {}
        done_lock = threading.Lock()
        work_q: "queue.Queue[int]" = queue.Queue()
        for bi in range(n_batches):
            work_q.put(bi)
        # Work-ahead budget: a worker takes a permit before it starts a batch
        # and the consumer returns it when that batch is yielded, so `done`
        # holds at most prefetch_batches + num_workers batches even when
        # batch 0 is the slow one.
        budget = threading.Semaphore(self.prefetch_batches + self.num_workers)

        def worker():
            while not stop.is_set():
                if not budget.acquire(timeout=0.1):
                    continue  # re-check stop: the consumer may have gone
                try:
                    bi = work_q.get_nowait()
                except queue.Empty:
                    budget.release()
                    return
                try:
                    result: object = self._batch(epoch, bi, batches[bi])
                except BaseException as e:  # handed to the consumer, which raises
                    result = e              # it: a dead thread would hang the loop
                with done_lock:
                    done[bi] = result
                out_q.put(bi)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        next_to_yield = 0
        try:
            for _ in range(n_batches):
                out_q.get()
                while True:  # yield in order, to stay deterministic
                    with done_lock:
                        if next_to_yield not in done:
                            break
                        batch = done.pop(next_to_yield)
                    next_to_yield += 1
                    budget.release()
                    if isinstance(batch, BaseException):
                        raise batch
                    yield batch
        finally:
            stop.set()

    def iter_padded(self) -> Iterator[tuple]:
        """Every dataset item once, in order, the tail batch padded with its
        last item; yields (batch, n_valid)."""
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, 0xE7A1))
        for start in range(0, n, self.batch_size):
            idx = list(range(start, min(start + self.batch_size, n)))
            n_valid = len(idx)
            idx += [idx[-1]] * (self.batch_size - n_valid)
            samples = [self.dataset.get(int(i), rng) for i in idx]
            yield normalize_batch(np.stack(samples)), n_valid

    def first_n(self, n: int) -> np.ndarray:
        """The first n dataset items in order (display batches)."""
        rng = np.random.default_rng((self.seed, 0xD15B))
        samples = [self.dataset.get(i, rng) for i in range(min(n, len(self.dataset)))]
        return normalize_batch(np.stack(samples))


def _make_dataset(cfg: Config, which: str, train: bool) -> _Dataset:
    data = cfg.data
    size_a, size_b = data.resolved_sizes()
    new_size = size_a if which.endswith("a") else size_b
    if train:
        spec = TransformSpec(new_size=new_size, crop_h=data.crop_image_height,
                             crop_w=data.crop_image_width, flip=True)
    else:  # test loaders crop to new_size
        spec = TransformSpec(new_size=new_size, crop_h=new_size, crop_w=new_size,
                             flip=False)
    if data.synthetic:
        hw = (spec.crop_h or new_size or 256, spec.crop_w or new_size or 256)
        # zlib.crc32, not hash(): str hashing is randomized per interpreter
        return SyntheticDataset(size=max(64, cfg.batch_size * 8), image_hw=hw,
                                seed=zlib.crc32(which.encode()) % (2 ** 31))
    if data.data_root:
        sub = {"train_a": "trainA", "train_b": "trainB",
               "test_a": "testA", "test_b": "testB"}[which]
        ds = ImageDataset(list_images_folder(os.path.join(data.data_root, sub)), spec)
    else:
        folder = getattr(data, f"data_folder_{which}")
        lst = getattr(data, f"data_list_{which}")
        if folder is None or lst is None:
            raise ValueError(f"No data_root and no data_folder/list for {which}")
        ds = ImageDataset(list_images_filelist(folder, lst), spec)
    if not (ds.native and all(p.lower().endswith((".jpg", ".jpeg")) for p in ds.paths)):
        require_pillow()  # the native core decodes JPEGs only
    return ds


def get_all_data_loaders(cfg: Config, seed: int = 0):
    """(train_a, train_b, test_a, test_b). Train loaders emit uint8 when
    `tpu.uint8_transfer` (a 4x smaller host->device copy); test loaders
    emit float32 for the host-side display and eval consumers."""
    train_emit = "uint8" if cfg.tpu.uint8_transfer else "float32"
    loaders = []
    for which, train in [("train_a", True), ("train_b", True),
                         ("test_a", False), ("test_b", False)]:
        ds = _make_dataset(cfg, which, train)
        loaders.append(DataLoader(ds, cfg.batch_size, train,
                                  num_workers=cfg.data.num_workers, seed=seed,
                                  emit=train_emit if train else "float32"))
    return tuple(loaders)


def device_prefetch(iterator, n: int = 2,
                    device: Union[str, torch.device] = "cpu") -> Iterator[torch.Tensor]:
    """Yield the host batches of `iterator` as tensors on `device`, with the
    next `n` host->device copies in flight.

    On CUDA each batch is pinned and copied with `non_blocking=True` on a
    side stream; the consumer's stream waits on that copy's event before the
    batch is handed over, the device tensor is recorded on the consumer's
    stream (so the caching allocator does not reuse it while that stream's
    work reads it), and the pinned host tensor is held until its copy has
    finished. On the CPU the batches are yielded as tensors, uncopied.
    """
    device = torch.device(device)
    it = iter(iterator)
    buf: collections.deque = collections.deque()      # (pinned host, device, copy event)
    retired: collections.deque = collections.deque()  # (pinned host, copy event)

    def put(x):
        while retired and retired[0][1].query():
            retired.popleft()
        host = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
        with torch.cuda.stream(side):
            dev = host.to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return host, dev, copied

    try:
        if device.type != "cuda":
            for x in it:
                yield torch.from_numpy(np.asarray(x))
            return
        side = torch.cuda.Stream(device)
        for x in it:
            buf.append(put(x))
            if len(buf) >= n:
                break
        while buf:
            host, dev, copied = buf.popleft()
            nxt = next(it, None)
            if nxt is not None:
                buf.append(put(nxt))
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(copied)
            dev.record_stream(consumer)
            retired.append((host, copied))
            del host
            yield dev
    finally:
        for entry in list(buf) + list(retired):
            entry[-1].synchronize()
        close = getattr(it, "close", None)
        if close is not None:
            close()
