"""ImageNet-class image pipeline: image tree -> uint8 record shards ->
augmentation on the device (the port's counterpart of
``autodist_tpu/data/imagenet.py:29-384``).

- **Offline prep** (:func:`prepare_image_shards`): decode, resize the short
  side to ``record_size`` and center-crop, into row-aligned uint8 NHWC
  ``images-*.npy`` and int32 ``labels-*.npy`` shards with an
  ``images-meta.json`` sidecar: the files the native ``DataLoader(files=...)``
  memory-maps. PIL is imported only here.
- **Augmentation on the device, inside the step** (:func:`augment_images`):
  a per-example ``image_size`` crop at ``crop_yx``, a horizontal flip, the
  channel-mean subtraction and a cast, as one gather over the record batch
  (no Python loop over examples). The crop offsets and flip bits are drawn
  on the host (:class:`AugmentingBatcher`), two small int arrays, so the
  step stays a pure function of its inputs.
- **The record pool** (:class:`DeviceDatasetCache`): uint8 records resident
  on the card, each batch gathered and augmented there, while fresh records
  replace pool rows round-robin, each transfer issued ``refresh_interval``
  steps before it is applied.
"""

import functools
import glob as globlib
import json
import logging
import os
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from autodist_tpu_torch.models.common import make_classification_loss_fn
from autodist_tpu_torch.utils.device import resolve_device

_log = logging.getLogger("autodist_tpu_torch")

# RGB means (subtraction only, no std scaling), as in the JAX package.
CHANNEL_MEANS = (123.68, 116.78, 103.94)

META_NAME = "images-meta.json"
_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _iter_image_files(src_dir: str) -> Iterator[Tuple[str, str]]:
    """(class name, path) over a ``src_dir/<class>/<image>`` tree, sorted."""
    classes = sorted(d for d in os.listdir(src_dir)
                     if os.path.isdir(os.path.join(src_dir, d)))
    if not classes:
        raise ValueError(f"{src_dir!r} has no class subdirectories")
    for cls in classes:
        for name in sorted(os.listdir(os.path.join(src_dir, cls))):
            if name.lower().endswith(_EXTS):
                yield cls, os.path.join(src_dir, cls, name)


def _decode_record(path: str, record_size: int) -> np.ndarray:
    """One image file -> uint8 ``[record_size, record_size, 3]``: the short
    side resized to ``record_size`` (bilinear), then a center crop."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = record_size / min(w, h)
        nw, nh = max(record_size, round(w * scale)), max(record_size, round(h * scale))
        im = im.resize((nw, nh), Image.BILINEAR)
        left, top = (nw - record_size) // 2, (nh - record_size) // 2
        im = im.crop((left, top, left + record_size, top + record_size))
        return np.asarray(im, np.uint8)


def prepare_image_shards(src_dir: str, directory: str, record_size: int = 256,
                         rows_per_shard: int = 1024,
                         shuffle_seed: Optional[int] = 0) -> Dict[str, List[str]]:
    """Decode a ``src_dir/<class>/<image>`` tree into row-aligned uint8
    ``images-*.npy`` and int32 ``labels-*.npy`` shards under ``directory``
    (labels: the sorted class-directory index; files shuffled once with
    ``shuffle_seed``, None keeps tree order), and write ``images-meta.json``
    (record_size, rows, classes). Returns the ``DataLoader(files=...)``
    dict."""
    if record_size < 8:
        raise ValueError("record_size must be >= 8")
    if rows_per_shard < 1:
        raise ValueError("rows_per_shard must be >= 1")
    entries = list(_iter_image_files(src_dir))
    if not entries:
        raise ValueError(f"no image files under {src_dir!r}")
    classes = sorted({cls for cls, _ in entries})
    cls_id = {c: i for i, c in enumerate(classes)}
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(entries)

    os.makedirs(directory, exist_ok=True)
    for key in ("images", "labels"):
        for stale in globlib.glob(os.path.join(globlib.escape(directory), f"{key}-*.npy")):
            os.remove(stale)

    img_buf = np.empty((rows_per_shard, record_size, record_size, 3), np.uint8)
    lab_buf = np.empty((rows_per_shard,), np.int32)
    n_buf = 0
    paths: Dict[str, List[str]] = {"images": [], "labels": []}

    def flush():
        nonlocal n_buf
        if n_buf == 0:
            return
        for key, buf in (("images", img_buf), ("labels", lab_buf)):
            path = os.path.join(directory, f"{key}-{len(paths[key]):05d}.npy")
            np.save(path, buf[:n_buf])
            paths[key].append(path)
        n_buf = 0

    n_rows = 0
    for cls, path in entries:
        img_buf[n_buf] = _decode_record(path, record_size)
        lab_buf[n_buf] = cls_id[cls]
        n_buf += 1
        n_rows += 1
        if n_buf == rows_per_shard:
            flush()
    flush()

    with open(os.path.join(directory, META_NAME), "w") as f:
        json.dump({"record_size": record_size, "rows": n_rows, "classes": classes}, f,
                  indent=1)
    _log.info("Prepared %d image records (%dx%d uint8, %d classes) across %d shards in %s",
              n_rows, record_size, record_size, len(classes), len(paths["images"]), directory)
    return paths


def read_meta(directory: str) -> Optional[dict]:
    path = os.path.join(directory, META_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def open_image_loader(directory: str, batch_size: int, **loader_kw):
    """``(DataLoader, meta)`` over a prepared shard directory."""
    from autodist_tpu_torch.data.loader import DataLoader
    meta = read_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no {META_NAME} under {directory!r} "
                                f"(prepare_image_shards writes one)")
    files = {k: sorted(globlib.glob(os.path.join(globlib.escape(directory), f"{k}-*.npy")))
             for k in ("images", "labels")}
    return DataLoader(files=files, batch_size=batch_size, **loader_kw), meta


def augment_images(images, crop_yx, flip, image_size: int,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Per-example ``image_size`` crop at ``crop_yx``, horizontal flip where
    ``flip``, channel-mean subtraction, cast: uint8 ``[B, R, R, 3]`` ->
    ``[B, S, S, 3]`` (f32, or ``dtype``), one gather on ``images``' device."""
    images = torch.as_tensor(images)
    dev = images.device
    crop = torch.as_tensor(crop_yx, device=dev).long()
    flip = torch.as_tensor(flip, device=dev).bool()
    steps = torch.arange(image_size, device=dev)
    rows = crop[:, :1] + steps                                  # [B, S]
    cols = crop[:, 1:] + torch.where(flip[:, None], image_size - 1 - steps, steps)
    batch = torch.arange(images.shape[0], device=dev)[:, None, None]
    x = images[batch, rows[:, :, None], cols[:, None, :]]      # [B, S, S, 3]
    x = x.float() - _channel_means(dev)
    return x.to(dtype) if dtype is not None else x


@functools.lru_cache(maxsize=None)
def _channel_means(device: torch.device) -> torch.Tensor:
    """The f32 channel means on ``device``, copied there once: a copy from
    the host in every step would make the host wait for the stream."""
    return torch.tensor(CHANNEL_MEANS, dtype=torch.float32, device=device)


def make_augmented_loss_fn(model, image_size: int, dtype: Optional[torch.dtype] = None):
    """Classification loss over raw record batches (keys ``images``, uint8
    records; ``labels``; ``crop_yx``; ``flip``: the
    :class:`AugmentingBatcher` layout), augmenting inside the step."""

    classify = make_classification_loss_fn(model)

    def loss_fn(params, batch):
        x = augment_images(batch["images"], batch["crop_yx"], batch["flip"], image_size,
                           dtype)
        return classify(params, {"images": x, "labels": batch["labels"]})

    return loss_fn


class DeviceDatasetCache:
    """A record pool resident on the device, refreshed in the background from
    the loader.

    Every step gathers its batch from the pool and augments it on the device
    (:func:`augment_images`), so no image bytes cross the host link on the
    critical path; meanwhile ``refresh_rows`` fresh records replace pool
    rows round-robin every ``refresh_interval`` steps. Each refresh is
    copied from pinned memory on a side stream and applied at the next
    refresh, ``refresh_interval`` steps later, so the copy hides under the
    steps. A pool that holds every row the loader can serve stops
    refreshing: the dataset is fully cached."""

    #: The pool's memory budget when ``pool_rows`` is unset: about 21,800
    #: records at record_size 224, 16,400 at 256 (the JAX package's default;
    #: not retuned for the card's 80 GB).
    DEFAULT_POOL_BYTES = 4 << 30

    def __init__(self, loader, *, record_size: int, image_size: int,
                 dtype: Optional[torch.dtype] = None, pool_rows: Optional[int] = None,
                 refresh_rows: int = 64, refresh_interval: int = 16,
                 train: bool = True, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        if image_size > record_size:
            raise ValueError(f"image_size {image_size} exceeds record_size {record_size}")
        self._loader = loader
        self.image_size = image_size
        self.record_size = record_size
        self.train = train
        self.device = resolve_device(device)
        self._dtype = dtype or torch.float32
        self._rng = np.random.Generator(np.random.PCG64(seed))
        if pool_rows is None:
            pool_rows = max(1, self.DEFAULT_POOL_BYTES // (record_size * record_size * 3))
        # Whole loader batches only (drop-last): a larger pool would take
        # the next epoch's rows again.
        servable = loader.n_rows - loader.n_rows % loader.batch_size
        self._rows = min(pool_rows, servable)
        self._buf_imgs: Optional[np.ndarray] = None     # undrained loader rows
        self._buf_labs: Optional[np.ndarray] = None
        self._refresh_rows = min(refresh_rows, self._rows) if refresh_rows else 0
        self._refresh_interval = max(1, refresh_interval)
        self._step = 0
        self._cursor = 0
        self._pending = None        # (rows on the device, labels, start, copy event)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        imgs = np.empty((self._rows, record_size, record_size, 3), np.uint8)
        labs = np.empty((self._rows,), np.int32)
        filled = 0
        while filled < self._rows:
            raw = loader.next()
            take = min(len(raw["images"]), self._rows - filled)
            imgs[filled:filled + take] = raw["images"][:take]
            labs[filled:filled + take] = raw["labels"][:take]
            filled += take
        self._pool = torch.from_numpy(imgs).to(self.device)
        self._labels = labs          # on the host: 4 bytes a row

    @property
    def pool_rows(self) -> int:
        return self._rows

    def _copy_in(self, rows: np.ndarray):
        """``rows`` on the device, and the event its copy records (None on
        the host)."""
        host = torch.from_numpy(np.ascontiguousarray(rows))
        if self._stream is None:
            return host.clone(), None
        host = host.pin_memory()
        with torch.cuda.stream(self._stream):
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _tick_refresh(self):
        """Apply last tick's transfer (landed by now), then issue the next."""
        servable = self._loader.n_rows - self._loader.n_rows % self._loader.batch_size
        if self._refresh_rows == 0 or servable <= self._rows:
            self._refresh_rows = 0
            return
        if self._pending is not None:
            rows_dev, labs, start, event = self._pending
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                rows_dev.record_stream(stream)
            self._pool[start:start + len(labs)].copy_(rows_dev)
            self._labels[start:start + len(labs)] = labs
            self._pending = None
        # Drain whole loader batches refresh_rows at a time: the loader's
        # batch is the training batch, usually larger.
        if self._buf_imgs is None or len(self._buf_imgs) < self._refresh_rows:
            raw = self._loader.next()
            if self._buf_imgs is None or not len(self._buf_imgs):
                self._buf_imgs, self._buf_labs = raw["images"], raw["labels"]
            else:
                self._buf_imgs = np.concatenate([self._buf_imgs, raw["images"]])
                self._buf_labs = np.concatenate([self._buf_labs, raw["labels"]])
        n = min(self._refresh_rows, len(self._buf_imgs), self._rows - self._cursor)
        rows_dev, event = self._copy_in(self._buf_imgs[:n])
        self._pending = (rows_dev, self._buf_labs[:n].astype(np.int32), self._cursor, event)
        self._buf_imgs = self._buf_imgs[n:]
        self._buf_labs = self._buf_labs[n:]
        self._cursor += n
        if self._cursor >= self._rows:
            self._cursor = 0

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device without waiting for the stream:
        a copy from pageable memory may synchronize it (and does unless
        ``non_blocking``), and the host would then wait out the previous
        step before launching this one. From pinned memory it does not."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def next_batch(self, batch_size: int) -> Dict[str, object]:
        """One batch assembled on the device: ``{"images": [B, S, S, 3],
        "labels": [B] int32}`` tensors, ready for the plain classification
        loss."""
        if self._step % self._refresh_interval == 0:
            with record_function("DeviceDatasetCache.refresh"):
                self._tick_refresh()
        self._step += 1
        with record_function("DeviceDatasetCache.gather"):
            idx = self._rng.integers(0, self._rows, size=batch_size, dtype=np.int32)
            margin = self.record_size - self.image_size
            if self.train:
                crop = self._rng.integers(0, margin + 1, size=(batch_size, 2), dtype=np.int32)
                flip = self._rng.random(batch_size) < 0.5
            else:
                crop = np.full((batch_size, 2), margin // 2, np.int32)
                flip = np.zeros(batch_size, bool)
            images = augment_images(self._pool.index_select(0, self._put(idx).long()),
                                    self._put(crop), self._put(flip),
                                    self.image_size, self._dtype)
        return {"images": images, "labels": self._put(self._labels[idx])}


class AugmentingBatcher:
    """Adds per-example crop offsets and flip bits to raw record batches:
    ``train=True`` draws uniform crops and 50% flips (seeded); ``train=False``
    the center crop and no flip (the eval preprocessing)."""

    def __init__(self, loader, image_size: int, record_size: int, train: bool = True,
                 seed: int = 0):
        if image_size > record_size:
            raise ValueError(f"image_size {image_size} exceeds record_size {record_size}")
        self._loader = loader
        self.image_size = image_size
        self.record_size = record_size
        self.train = train
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def next(self) -> Dict[str, np.ndarray]:
        raw = self._loader.next()
        b = len(raw["images"])
        margin = self.record_size - self.image_size
        if self.train:
            crop = self._rng.integers(0, margin + 1, size=(b, 2), dtype=np.int32)
            flip = self._rng.random(b) < 0.5
        else:
            crop = np.full((b, 2), margin // 2, np.int32)
            flip = np.zeros(b, bool)
        return {"images": raw["images"], "labels": raw["labels"].astype(np.int32),
                "crop_yx": crop, "flip": flip}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()
