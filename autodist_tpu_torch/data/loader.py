"""Host data pipeline: a native threaded prefetch loader with a numpy
fallback (the port's copy of ``autodist_tpu/data/loader.py:51-399``).

``DataLoader`` serves shuffled, fixed-size batches from in-memory arrays or
from row-aligned ``.npy`` shard files (``files=``, memory-mapped):

- **Native path** (default): ``native/loader.cc``, a byte-identical copy of
  the JAX package's, compiled with ``g++`` at first use into ``build/``
  (:mod:`autodist_tpu_torch.utils.native_build`) and driven through ctypes.
  A C++ worker thread reshuffles the rows each epoch (``std::mt19937_64``
  seeded with ``seed``) and gathers them into a prefetch ring off the GIL.
- **Fallback path**: the same semantics in numpy, used where no compiler is
  found. It is a host component's fallback, as in the JAX package, not a
  device kernel's; its batches differ from the native path's only in the
  shuffle's random stream.

Both paths give the JAX loader's batches bit for bit for the same seed.
``device_prefetch`` hands a loader to the port's device feed
(:func:`autodist_tpu_torch.data.prefetch.prefetch_to_device`);
``save_shards`` writes the shard files ``files=`` reads, and
``shard_files_for_process`` splits them across processes.
"""

import ctypes
import glob
import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

_log = logging.getLogger("autodist_tpu_torch")
_BUILD_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False

FileSpec = Union[str, os.PathLike, Sequence[Union[str, os.PathLike]]]


def _source_path() -> str:
    return os.path.join(os.path.dirname(__file__), "native", "loader.cc")


def _build_native() -> Optional[ctypes.CDLL]:
    """Compile and load the native loader once; None when unavailable."""
    global _LIB, _LIB_FAILED
    with _BUILD_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        from autodist_tpu_torch.utils.native_build import build_native_lib
        lib = build_native_lib(_source_path(), "loader", extra_flags=("-O3", "-lpthread"))
        if lib is None:
            _LIB_FAILED = True
            return None
        lib.dl_create_sharded.restype = ctypes.c_void_p
        lib.dl_create_sharded.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.dl_epochs_completed.restype = ctypes.c_uint64
        lib.dl_epochs_completed.argtypes = [ctypes.c_void_p]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def save_shards(arrays: Dict[str, np.ndarray], directory: str,
                rows_per_shard: int) -> Dict[str, List[str]]:
    """Write ``arrays`` as row-aligned ``<key>-00000.npy``, ... shards under
    ``directory`` (a key's earlier shards removed first) and return the
    ``files=`` dict that loads them back."""
    if rows_per_shard < 1:
        raise ValueError("rows_per_shard must be >= 1")
    lengths = {k: len(v) for k, v in arrays.items()}
    if len(set(lengths.values())) != 1:
        raise ValueError(f"All arrays must share a leading dim, got {lengths}")
    n = next(iter(lengths.values()))
    os.makedirs(directory, exist_ok=True)
    out: Dict[str, List[str]] = {}
    for key, arr in arrays.items():
        for stale in glob.glob(os.path.join(glob.escape(directory),
                                            f"{glob.escape(key)}-*.npy")):
            os.remove(stale)
        paths = []
        for i, start in enumerate(range(0, n, rows_per_shard)):
            path = os.path.join(directory, f"{key}-{i:05d}.npy")
            np.save(path, np.ascontiguousarray(arr[start:start + rows_per_shard]))
            paths.append(path)
        out[key] = paths
    return out


def shard_files_for_process(files: Dict[str, FileSpec], process_id: int,
                            num_processes: int) -> Dict[str, List[str]]:
    """Process ``i`` of ``n`` reads shards ``i::n`` of every key (keys stay
    row-aligned: all drop the same shard indices). Needs at least as many
    shards as processes."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of [0, {num_processes})")
    out: Dict[str, List[str]] = {}
    for key, spec in files.items():
        paths = [spec] if isinstance(spec, (str, os.PathLike)) else list(spec)
        mine = [os.fspath(p) for p in paths[process_id::num_processes]]
        if not mine:
            raise ValueError(
                f"files[{key!r}]: {len(paths)} shard(s) cannot feed "
                f"{num_processes} processes; re-prep with smaller "
                f"rows_per_shard")
        out[key] = mine
    return out


def _open_segments(files: Dict[str, FileSpec]) -> Dict[str, List[np.ndarray]]:
    """mmap every shard; check row alignment across keys and dtype and row
    shape across a key's shards."""
    segs: Dict[str, List[np.ndarray]] = {}
    for key, spec in files.items():
        paths = [spec] if isinstance(spec, (str, os.PathLike)) else list(spec)
        if not paths:
            raise ValueError(f"files[{key!r}] names no shards")
        arrs = [np.load(os.fspath(p), mmap_mode="r") for p in paths]
        head = arrs[0]
        for p, a in zip(paths, arrs):
            if a.dtype != head.dtype or a.shape[1:] != head.shape[1:]:
                raise ValueError(
                    f"files[{key!r}]: shard {p} is {a.dtype}{a.shape[1:]} but "
                    f"the first shard is {head.dtype}{head.shape[1:]}")
        segs[key] = arrs
    counts = {k: [len(a) for a in v] for k, v in segs.items()}
    first = next(iter(counts.values()))
    for c in counts.values():
        if c != first:
            raise ValueError(f"Shards must be row-aligned across keys: per-shard rows "
                             f"{counts}")
    return segs


class DataLoader:
    """Shuffled fixed-size batches over a dict of same-length arrays, or over
    row-aligned ``.npy`` shard files (``files=``, memory-mapped).

    An endless stream: epochs reshuffle, and a tail shorter than a batch is
    dropped (static shapes). ``native=None`` takes the native path when it
    builds; ``native=False`` forces the numpy path; ``native=True`` raises
    when the native path does not build."""

    def __init__(self, arrays: Optional[Dict[str, np.ndarray]] = None,
                 batch_size: int = 1, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, native: Optional[bool] = None,
                 files: Optional[Dict[str, FileSpec]] = None):
        if (arrays is None) == (files is None):
            raise ValueError("pass exactly one of arrays= or files=")
        if files is not None:
            segs = _open_segments(files)
        else:
            if not arrays:
                raise ValueError("DataLoader needs at least one array")
            lengths = {k: len(v) for k, v in arrays.items()}
            if len(set(lengths.values())) != 1:
                raise ValueError(f"All arrays must share a leading dim, got {lengths}")
            segs = {k: [np.asarray(v)] for k, v in arrays.items()}

        # Rows must be C-contiguous (one memcpy each). A file shard that is
        # not is refused: copying it would read the whole file into memory.
        def as_rows(key, v):
            if v.flags.c_contiguous:
                return v
            if files is not None:
                raise ValueError(
                    f"files[{key!r}]: shard is not C-contiguous "
                    f"(Fortran-order .npy?); rewrite it row-major — copying a "
                    f"memory-mapped shard would materialize the whole file")
            return np.ascontiguousarray(v)

        self._segs = {k: [as_rows(k, v) for v in vs] for k, vs in segs.items()}
        self._keys = list(self._segs)
        self._seg_rows = [len(v) for v in self._segs[self._keys[0]]]
        self.n_rows = sum(self._seg_rows)
        if batch_size < 1 or batch_size > self.n_rows:
            raise ValueError(f"batch_size {batch_size} out of range [1, {self.n_rows}]")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = max(1, prefetch)

        self._lib = _build_native() if native in (None, True) else None
        if native is True and self._lib is None:
            raise RuntimeError("native=True but the native loader failed to build")
        # A prefetch producer thread may be inside dl_next when close() runs:
        # close() stops new calls and waits for those in flight before
        # dl_destroy frees the loader.
        self._native_cv = threading.Condition()
        self._native_inflight = 0
        self._closing = False
        self._handle = None
        if self._lib is not None:
            self._handle = self._create_native()
            if not self._handle:
                raise RuntimeError("dl_create rejected the loader configuration")
        else:
            self._rng = np.random.RandomState(seed)
            self._perm = None
            self._cursor = 0
            self._epochs = 0
            self._seg_starts = np.cumsum([0] + self._seg_rows)

    def _create_native(self):
        n, n_seg = len(self._keys), len(self._seg_rows)
        ptrs = (ctypes.c_void_p * (n * n_seg))(*[
            self._segs[k][s].ctypes.data for k in self._keys for s in range(n_seg)])
        row_bytes = (ctypes.c_uint64 * n)(*[self._row_bytes(k) for k in self._keys])
        seg_rows = (ctypes.c_uint64 * n_seg)(*self._seg_rows)
        return self._lib.dl_create_sharded(n, n_seg, ptrs, row_bytes, seg_rows,
                                           self.batch_size, self.prefetch,
                                           int(self.shuffle), self.seed)

    def _row_bytes(self, key: str) -> int:
        head = self._segs[key][0]
        return head.nbytes // len(head) if len(head) else 0

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    @property
    def epochs_completed(self) -> int:
        """Epoch wraps so far: on the native path counted by the producer,
        which runs up to ``prefetch`` batches ahead; on the numpy path by
        the consumer."""
        if self._handle is not None:
            return int(self._lib.dl_epochs_completed(self._handle))
        return self._epochs

    def next(self) -> Dict[str, np.ndarray]:
        """The next batch (on the native path, blocks on the prefetch ring).
        Raises after :meth:`close`."""
        if self._closing:
            raise RuntimeError("Native loader was shut down")
        out = {k: np.empty((self.batch_size,) + self._segs[k][0].shape[1:],
                           self._segs[k][0].dtype) for k in self._keys}
        if self._lib is not None:
            with self._native_cv:
                if self._closing or self._handle is None:
                    raise RuntimeError("Native loader was shut down")
                handle = self._handle
                self._native_inflight += 1
            try:
                ptrs = (ctypes.c_void_p * len(self._keys))(
                    *[out[k].ctypes.data for k in self._keys])
                rc = self._lib.dl_next(handle, ptrs)
            finally:
                with self._native_cv:
                    self._native_inflight -= 1
                    self._native_cv.notify_all()
            if rc != 0:
                raise RuntimeError("Native loader was shut down")
            return out
        if self._perm is None or self.n_rows - self._cursor < self.batch_size:
            if self._perm is not None:
                self._epochs += 1
            self._perm = (self._rng.permutation(self.n_rows) if self.shuffle
                          else np.arange(self.n_rows))
            self._cursor = 0
        idx = self._perm[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        seg = np.searchsorted(self._seg_starts, idx, side="right") - 1
        local = idx - self._seg_starts[seg]
        groups = [(s, seg == s) for s in np.unique(seg)]
        for k in self._keys:
            for s, mask in groups:
                out[k][mask] = self._segs[k][s][local[mask]]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def close(self, timeout_s: float = 60.0):
        """Shut the native loader down: new :meth:`next` calls fail, those in
        flight drain (a bounded wait) before ``dl_destroy``; past
        ``timeout_s`` the handle is leaked with a warning rather than freed
        under a live waiter."""
        if self._handle is None:
            return
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._native_cv:
            self._closing = True
            while self._native_inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    _log.warning("DataLoader.close: %d native next() call(s) still in "
                                 "flight after %.0fs; leaking the native handle",
                                 self._native_inflight, timeout_s)
                    self._handle = None
                    return
                self._native_cv.wait(min(0.2, remaining))
            handle, self._handle = self._handle, None
        self._lib.dl_destroy(handle)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def device_prefetch(loader, runner, depth: int = 2, unroll: int = 1,
                    workers: Optional[int] = None):
    """Batches laid out for ``runner`` (``runner.shard_batch``: this rank's
    rows, on its device), ``depth`` ahead of the step on a background
    producer (:func:`autodist_tpu_torch.data.prefetch.prefetch_to_device`).
    Close the returned producer before the loader. With ``unroll=K`` each
    item is a block of K loader batches (``runner.shard_block``) for
    ``runner.run_many``, ``depth`` blocks ahead; a loader that runs out
    mid-block drops the partial remainder (logged) and ends
    (``autodist_tpu/data/loader.py:371-399``)."""
    from autodist_tpu_torch.data import prefetch
    return prefetch.prefetch_to_device(loader, runner, depth=depth, unroll=unroll,
                                       workers=workers)
