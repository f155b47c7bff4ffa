"""Serving API: a generator checkpoint behind a uint8-in / uint8-out Translator.

Port of `aclgan_tpu/serving.py`:

- `Translator`: requests are uint8 HWC images, resized and center-cropped to
  one square size; batches are padded to a fixed size; styles are explicit,
  drawn from a seeded `torch.Generator`, or encoded from a style image.
- `BucketedTranslator`: a fixed menu of square size buckets; each request
  image goes to its nearest bucket, so mixed-size traffic runs at most one
  device shape per bucket.
- `AsyncTranslator`: a request queue and a worker thread that coalesces
  concurrent single-image requests into device batches (latency window +
  max batch), returning futures.

`Translator(devices=k)` serves each batch on k devices: one generator
replica a device, each taking its k-th of the batch's rows (the JAX
package's batch-sharded mesh, `aclgan_tpu/serving.py:110-127`); -1 is every
visible GPU. With `device="cpu"` it runs k replicas on the CPU.

    tr = Translator("configs/male2female.yaml", "gen_00350000.pt")
    outs = tr(list_of_uint8_images)            # list of HxWx3 uint8

    srv = AsyncTranslator(BucketedTranslator(cfg, ckpt, buckets=(128, 256)))
    fut = srv.submit(img)                      # concurrent callers batched
    out = fut.result()
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from aclgan_tpu_torch.config import Config, load_config
from aclgan_tpu_torch.data.transforms import normalize_batch, prep_image
from aclgan_tpu_torch.trainer import ACLGAN, resolve_device
from aclgan_tpu_torch.utils.checkpoint import load_generators


def translate_u8(model: ACLGAN, x: torch.Tensor, z: torch.Tensor, a2b: bool = True):
    """The served step: `model.translate` on uint8 NHWC images, then [-1, 1]
    -> uint8. Returns (uint8 NHWC images, mask NHWC or None). `export.py`
    traces this same function."""
    img, mask = model.translate(x, z, a2b=a2b)
    return torch.clamp((img.float() + 1.0) * 127.5, 0, 255).to(torch.uint8), mask


class Translator:
    def __init__(
        self,
        config: Union[str, Config],
        checkpoint: str,
        a2b: bool = True,
        batch_size: int = 32,   # requests are padded to this batch
        size: Optional[int] = None,
        seed: int = 0,
        devices: int = 1,
        device: Union[str, torch.device] = "cuda",
    ):
        cfg = load_config(config) if isinstance(config, str) else config
        self.cfg = cfg
        self.a2b = a2b
        self.batch_size = batch_size
        self.style_dim = cfg.gen.style_dim
        size_a, size_b = cfg.data.resolved_sizes()
        self.size = size or (size_a if a2b else size_b) or 256
        stride = 2 ** cfg.gen.n_downsample
        if self.size % stride:
            raise ValueError(f"size {self.size} must be a multiple of the "
                             f"generator stride {stride} (2**n_downsample)")
        replica_devices = _replica_devices(device, devices, batch_size)
        self.model = ACLGAN(cfg, device=replica_devices[0])
        load_generators(checkpoint, self.model)
        self.device = self.model.device
        self.replicas = [self.model]
        for dev in replica_devices[1:]:
            replica = ACLGAN(cfg, device=dev)
            for name in ("AB", "BA"):
                replica.gen(name).load_state_dict(self.model.gen(name).state_dict())
            self.replicas.append(replica)
        self._rng = torch.Generator().manual_seed(seed)
        self._rng_lock = threading.Lock()

    def encode_style(self, style_image: np.ndarray) -> np.ndarray:
        """Style code (1, style_dim) from a reference image."""
        x = torch.from_numpy(normalize_batch(prep_image(style_image, self.size)[None]))
        x = x.to(self.device).permute(0, 3, 1, 2).contiguous().to(self.model.dtype)
        gen = self.model.gen_AB if self.a2b else self.model.gen_BA
        with torch.inference_mode():
            return gen.encode_style(x).float().cpu().numpy()

    def random_style(self, n: int = 1) -> np.ndarray:
        """Draw n style codes from the serving RNG stream (thread-safe)."""
        with self._rng_lock:
            return torch.randn((n, self.style_dim), generator=self._rng).numpy()

    def __call__(self, images: Sequence[np.ndarray], styles: Optional[np.ndarray] = None,
                 return_masks: bool = False):
        """Translate a list of uint8 HWC images, one style per image (random
        if None). Batches are padded to `batch_size`."""
        n = len(images)
        if n == 0:
            return ([], None) if return_masks else []
        prepped = np.stack([prep_image(im, self.size) for im in images])
        styles = self._resolve_styles(styles, n)
        outs, masks = self._run_batches(prepped, styles)
        if return_masks:
            return outs, (masks if masks else None)
        return outs

    def _resolve_styles(self, styles, n: int) -> np.ndarray:
        if styles is None:
            styles = self.random_style(n)
        styles = np.asarray(styles, np.float32)
        if styles.ndim == 1:
            styles = np.broadcast_to(styles[None], (n, styles.shape[0]))
        return styles

    def _translate(self, x: torch.Tensor, z: torch.Tensor):
        """The served step on one padded batch: each replica translates its
        rows on its own device (every op, K1 included, follows its tensors'
        device, so launches on k devices overlap), and the outputs come back
        in row order."""
        if len(self.replicas) == 1:
            return translate_u8(self.model, x, z, self.a2b)
        parts = []
        for model, xs, zs in zip(self.replicas, x.chunk(len(self.replicas)),
                                 z.chunk(len(self.replicas))):
            dev = model.device
            parts.append(translate_u8(model, xs.to(dev, non_blocking=True),
                                      zs.to(dev, non_blocking=True), self.a2b))
        img = torch.cat([p[0].to(self.device) for p in parts])
        masks = [p[1] for p in parts]
        return img, None if masks[0] is None else torch.cat([m.to(self.device)
                                                              for m in masks])

    def _run_batches(self, prepped: np.ndarray, styles: np.ndarray):
        outs: List[np.ndarray] = []
        masks: List[np.ndarray] = []
        bs = self.batch_size
        for start in range(0, prepped.shape[0], bs):
            chunk = prepped[start:start + bs]
            zc = styles[start:start + bs]
            keep = chunk.shape[0]
            if keep < bs:  # fixed batch shape: pad the tail batch
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], bs - keep, 0)])
                zc = np.concatenate([zc, np.repeat(zc[-1:], bs - keep, 0)])
            # uint8 goes to the device; translate normalizes it there
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            z = torch.from_numpy(np.ascontiguousarray(zc)).to(self.device)
            with torch.inference_mode():
                img_u8, mask = self._translate(x, z)
            outs.extend(list(img_u8[:keep].cpu().numpy()))
            if mask is not None:
                masks.extend(list(mask[:keep].float().cpu().numpy()))
        return outs, masks


def _replica_devices(device: Union[str, torch.device], devices: int,
                     batch_size: int) -> List[torch.device]:
    """The devices of a Translator's replicas: `devices` of them (-1: every
    visible GPU, or one CPU), from `device` on."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        first = torch.cuda.current_device() if dev.index is None else dev.index
        n = count - first if devices == -1 else devices
    else:
        count, first = None, 0
        n = 1 if devices == -1 else devices
    if n < 1:
        raise ValueError(f"devices must be -1 or positive, got {devices}")
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by {n} devices")
    if count is not None and first + n > count:
        raise ValueError(f"mesh_data={n} > available devices {count - first}")
    if n == 1:
        return [dev]
    return [torch.device(dev.type, first + i) if count is not None else dev
            for i in range(n)]


class BucketedTranslator(Translator):
    """Multi-size serving on a fixed menu of device shapes.

    A fixed menu of square `buckets` (each a positive multiple of the
    generator stride 2**n_downsample); every request image is resized and
    cropped to its nearest bucket, and images are grouped per bucket before
    they reach the device, so steady-state traffic runs exactly len(buckets)
    device shapes (cuDNN picks its algorithms once per shape). `warmup()`
    runs each of them once upfront."""

    def __init__(self, config, checkpoint, buckets: Sequence[int] = (128, 192, 256),
                 **kw):
        super().__init__(config, checkpoint, **kw)
        stride = 2 ** self.cfg.gen.n_downsample
        bad = [b for b in buckets if b % stride or b <= 0]
        if bad:
            raise ValueError(f"buckets {bad} not positive multiples of the "
                             f"generator stride {stride}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._shapes: set = set()

    def pick_bucket(self, img: np.ndarray) -> int:
        """Smallest bucket >= the image's shortest side; else the largest
        bucket (never upscale more than the menu requires)."""
        short = min(img.shape[0], img.shape[1])
        for b in self.buckets:
            if b >= short:
                return b
        return self.buckets[-1]

    def __call__(self, images, styles=None, return_masks: bool = False):
        n = len(images)
        styles = self._resolve_styles(styles, n)
        by_bucket: Dict[int, List[int]] = {}
        for i, im in enumerate(images):
            by_bucket.setdefault(self.pick_bucket(np.asarray(im)), []).append(i)

        outs: List[Optional[np.ndarray]] = [None] * n
        masks: List[Optional[np.ndarray]] = [None] * n
        got_masks = False
        for bucket, idxs in by_bucket.items():
            prepped = np.stack([prep_image(images[i], bucket) for i in idxs])
            o, m = self._run_batches(prepped, styles[idxs])
            for j, i in enumerate(idxs):
                outs[i] = o[j]
                if m:
                    masks[i] = m[j]
                    got_masks = True
        if return_masks:
            return outs, (masks if got_masks else None)
        return outs

    def _run_batches(self, prepped: np.ndarray, styles: np.ndarray):
        self._shapes.add((self.batch_size, *prepped.shape[1:]))
        return super()._run_batches(prepped, styles)

    def warmup(self):
        """Run every (batch_size, bucket, bucket, 3) device shape once."""
        for b in self.buckets:
            self([np.zeros((b, b, 3), np.uint8)])

    def compiled_shapes(self) -> int:
        """The number of distinct (batch_size, bucket, bucket, 3) device
        shapes served so far: one per bucket at steady state, and repeat
        traffic adds none (the counterpart of the JAX jit cache size)."""
        return len(self._shapes)


class AsyncTranslator:
    """Async request batching over a (Bucketed)Translator.

    Concurrent callers `submit()` single images and receive futures; a worker
    thread coalesces queued requests — up to `max_batch` or until
    `max_wait_ms` after the first request of a batch — into one device call,
    on the device and CUDA stream that were current where it was built.
    Throughput of the batched path at single-request latency ~max_wait_ms.
    """

    def __init__(self, translator, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0):
        self.translator = translator
        # duck-typed: any (Bucketed)Translator or export.ExportedTranslator —
        # needs __call__(images, styles=), random_style(n), batch_size, and a
        # style dimension (`style_dim`, else the config's)
        self.style_dim = getattr(translator, "style_dim", None) or \
            translator.cfg.gen.style_dim
        self.max_batch = max_batch or translator.batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        device = torch.device(getattr(translator, "device", "cpu"))
        self._stream = (torch.cuda.current_stream(device) if device.type == "cuda"
                        else None)
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # outstanding-request accounting: queue-empty does NOT mean processed
        # (a dequeued batch may still be in flight), so close(drain=True)
        # waits on this counter instead of q.empty()
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._idle = threading.Condition(self._pending_lock)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="aclgan-serve")
        self._worker.start()

    def submit(self, image: np.ndarray,
               style: Optional[np.ndarray] = None) -> Future:
        fut: Future = Future()
        # the closed-check, pending increment, and enqueue are one atomic
        # step wrt close() (which sets _stop under the same lock): a submit
        # that wins the race has its item visible to the shutdown sweep, a
        # submit that loses raises — no future can be stranded in between
        with self._pending_lock:
            if self._stop.is_set():
                raise RuntimeError("AsyncTranslator is closed")
            self._pending += 1
            self._q.put((image, style, fut))
        return fut

    def _retire(self):
        with self._pending_lock:
            self._pending -= 1
            if self._pending <= 0:
                self._idle.notify_all()

    def _resolve(self, fut: Future, *, result=None, exc: Optional[Exception] = None):
        """Complete a future and retire it from the pending count. Must never
        raise: a caller may have cancelled the future (set_result on a
        cancelled/done future raises InvalidStateError), and an escape here
        would leak the pending count and poison the rest of the batch."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:
            pass  # future already cancelled/done — outcome dropped by caller
        finally:
            self._retire()

    def translate(self, image: np.ndarray,
                  style: Optional[np.ndarray] = None) -> np.ndarray:
        return self.submit(image, style).result()

    def _loop(self):
        # the device work runs here, on the device and stream current at __init__
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            self._serve()

    def _serve(self):
        while True:
            # never START a batch after close(): drain=True waits for
            # pending==0 before setting _stop, so this still drains; for
            # drain=False it makes shutdown prompt (only the in-flight batch
            # finishes) and leaves the backlog to close()'s sweep — the
            # worker provably never dequeues again, so the sweep can't race
            # it over queue items
            if self._stop.is_set():
                return
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run(batch)
            except Exception as e:  # last-ditch: never let the worker die
                # with futures unresolved — a dead worker would leave every
                # later submit() pending forever
                for _, _, fut in batch:
                    if not fut.done():
                        self._resolve(fut, exc=e)

    def _prep_request(self, image, style):
        """Validate/convert ONE request; raises on malformed input so a bad
        request fails only its own future, not the whole coalesced batch.
        A None style stays None here — _run draws ONE random_style(k) for all
        style-less requests of the coalesced batch."""
        arr = np.asarray(image)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(
                f"expected HxWx3 RGB image, got shape {arr.shape}")
        arr = arr.astype(np.uint8, copy=False)
        if style is None:
            return arr, None
        z = np.asarray(style, np.float32).reshape(-1)
        if z.shape[0] != self.style_dim:
            raise ValueError(
                f"style must have {self.style_dim} "
                f"elements, got {z.shape[0]}")
        return arr, z

    def _run(self, batch):
        # per-request validation: malformed requests fail individually and
        # are dropped from the device batch (innocent requests that shared
        # the latency window proceed)
        good = []
        for im, s, fut in batch:
            if not fut.set_running_or_notify_cancel():
                self._retire()  # caller cancelled while queued — skip it
                continue
            try:
                arr, z = self._prep_request(im, s)
            except Exception as e:
                self._resolve(fut, exc=e)
                continue
            good.append((arr, z, fut))
        if not good:
            return
        missing = [i for i, (_, z, _) in enumerate(good) if z is None]
        if missing:  # one batched draw for every default-style request
            zs = self.translator.random_style(len(missing))
            for j, i in enumerate(missing):
                arr, _, fut = good[i]
                good[i] = (arr, zs[j], fut)
        try:
            images = [arr for arr, _, _ in good]
            styles = np.stack([z for _, z, _ in good]).astype(np.float32)
            # host arrays out: every translator copies its outputs to the host
            outs = self.translator(images, styles=styles)
        except Exception as e:  # surface device errors to every waiter
            for _, _, fut in good:
                self._resolve(fut, exc=e)
            return
        for (_, _, fut), out in zip(good, outs):
            self._resolve(fut, result=out)

    def close(self, drain: bool = True):
        """Stop the worker; by default lets in-flight + queued requests
        finish (bounded by worker liveness — a dead worker can't drain)."""
        if drain:
            with self._idle:
                while self._pending > 0 and self._worker.is_alive():
                    self._idle.wait(timeout=0.1)
        with self._pending_lock:  # atomic wrt submit()'s closed-check
            self._stop.set()
        self._worker.join(timeout=10)
        # fail anything left behind (enqueued during shutdown or stranded by
        # a worker crash) instead of leaving futures forever pending
        leftovers = []
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for _, _, fut in leftovers:
            if not fut.done():
                self._resolve(fut, exc=RuntimeError("AsyncTranslator closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
