"""Masked-LM pretrain pipeline: text corpus -> BERT batches from disk (the
port's copy of ``autodist_tpu/data/mlm.py``: the masks are host numpy draws in
the same order, so one seed gives the JAX package's masks bit for bit).

Counterpart of the reference BERT benchmark's pretrain input
(``examples/benchmark/bert.py:82-98`` -> ``utils/input_pipeline.py``
``create_pretrain_dataset``: tfrecords with input_ids/segment_ids/
masked_lm_{positions,ids,weights} fields, masked OFFLINE by BERT's
create_pretraining_data). This pipeline splits that differently:

- **Prep** (:func:`prepare_mlm_shards`) streams a text corpus once and writes
  raw UNMASKED ``tokens-*.npy`` / ``token_types-*.npy`` shards — the same
  row-aligned files the native ``DataLoader(files=...)`` memory-maps. Rows are
  ``[CLS] words [SEP]`` (or ``[CLS] seg_a [SEP] seg_b [SEP]`` with
  ``segments=True``), padded to ``seq_len``.
- **Dynamic masking** (:class:`MLMBatcher`) draws a fresh 80/10/10 mask per
  batch on the host — every epoch sees different masks (static tfrecord
  masking shows the model one fixed mask forever; dynamic masking is the
  RoBERTa improvement and costs nothing here), deterministic under ``seed``.
  Output batches carry exactly the keys ``models/bert.py``'s
  ``make_mlm_loss_fn`` consumes: ``tokens, token_types, mlm_positions,
  mlm_targets, mlm_weights`` with a static ``max_predictions_per_seq`` slot
  count (the reference's fixed-slot layout — static shapes).

No next-sentence objective: the zoo's BERT has no NSP head (MLM-only, the
RoBERTa finding); ``segments=True`` still exercises the type-embedding path
the reference's segment_ids fed.

Special ids occupy the low range — ``pad=0`` (what the model's pad mask keys
on), ``cls=1``, ``sep=2``, ``mask=3`` — and corpus word ids are shifted up by
``N_SPECIAL``; the embedding must cover ``meta["vocab_size"]`` rows.
"""

import glob as globlib
import json
import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from autodist_tpu_torch.data.text_corpus import PathsSpec, Vocabulary, _resolve_paths, _words

_log = logging.getLogger("autodist_tpu_torch")

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
MASK_ID = 3
N_SPECIAL = 4

META_NAME = "mlm-meta.json"


def prepare_mlm_shards(files: PathsSpec, vocab: Vocabulary, directory: str,
                       seq_len: int, rows_per_shard: int = 1 << 15,
                       segments: bool = False, seed: int = 0) -> Dict[str, List[str]]:
    """Stream a corpus into raw MLM rows: ``tokens-*.npy`` + ``token_types-*.npy``.

    Each row packs ``seq_len - 2`` corpus words as ``[CLS] w.. [SEP]`` (types
    all 0); with ``segments=True``, ``seq_len - 3`` words split at a seeded
    random point into ``[CLS] a.. [SEP] b.. [SEP]`` with types 0/1 — the
    reference's segment_ids layout. Rows are full (no padding mid-corpus; the
    trailing partial row is dropped — static shapes). Word ids are shifted by
    ``N_SPECIAL``. Returns ``{"tokens": paths, "token_types": paths}`` and
    writes a ``mlm-meta.json`` sidecar the training side validates against.
    """
    if seq_len < (8 if segments else 4):
        raise ValueError(f"seq_len {seq_len} too short for the row layout")
    if rows_per_shard < 1:
        raise ValueError("rows_per_shard must be >= 1")
    os.makedirs(directory, exist_ok=True)
    for key in ("tokens", "token_types"):
        for stale in globlib.glob(os.path.join(globlib.escape(directory),
                                               f"{key}-*.npy")):
            os.remove(stale)

    n_words_row = seq_len - (3 if segments else 2)
    rng = np.random.RandomState(seed)
    tok_buf = np.empty((rows_per_shard, seq_len), np.int32)
    typ_buf = np.zeros((rows_per_shard, seq_len), np.int32)
    n_buf = 0
    n_rows = 0
    paths: Dict[str, List[str]] = {"tokens": [], "token_types": []}
    row_words: List[int] = []

    def flush():
        nonlocal n_buf
        if n_buf == 0:
            return
        for key, buf in (("tokens", tok_buf), ("token_types", typ_buf)):
            path = os.path.join(directory, f"{key}-{len(paths[key]):05d}.npy")
            np.save(path, buf[:n_buf])
            paths[key].append(path)
        n_buf = 0

    for word in _words(_resolve_paths(files)):
        row_words.append(N_SPECIAL + vocab.lookup(word))
        if len(row_words) < n_words_row:
            continue
        row = tok_buf[n_buf]
        types = typ_buf[n_buf]
        types[:] = 0
        if segments:
            # Split point away from the edges so both segments are real.
            lo = max(1, n_words_row // 4)
            split = int(rng.randint(lo, n_words_row - lo + 1))
            row[0] = CLS_ID
            row[1:1 + split] = row_words[:split]
            row[1 + split] = SEP_ID
            row[2 + split:2 + n_words_row] = row_words[split:]
            row[2 + n_words_row] = SEP_ID
            types[2 + split:] = 1
        else:
            row[0] = CLS_ID
            row[1:1 + n_words_row] = row_words
            row[1 + n_words_row] = SEP_ID
        row_words.clear()
        n_buf += 1
        n_rows += 1
        if n_buf == rows_per_shard:
            flush()
    flush()
    if not paths["tokens"]:
        raise ValueError(
            f"corpus has fewer than {n_words_row} words; no MLM rows")

    vocab_size = N_SPECIAL + vocab.vocab_size
    with open(os.path.join(directory, META_NAME), "w") as f:
        json.dump({"vocab_size": vocab_size, "seq_len": seq_len,
                   "rows": n_rows, "segments": segments,
                   "n_special": N_SPECIAL, "mask_id": MASK_ID,
                   "oov_buckets": vocab.oov_buckets}, f, indent=1)
    _log.info("Prepared %d MLM rows of len %d (segments=%s) across %d "
                 "shards in %s (vocab %d incl. %d specials)", n_rows, seq_len,
                 segments, len(paths["tokens"]), directory, vocab_size,
                 N_SPECIAL)
    return paths


def read_meta(directory: str) -> Optional[dict]:
    path = os.path.join(directory, META_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def open_mlm_loader(directory: str, batch_size: int, **loader_kw):
    """DataLoader over a prepared MLM shard directory (+ its meta) — the
    single place shard discovery lives (escaped glob: a directory named
    ``runs[2026]`` must not silently match nothing)."""
    from autodist_tpu_torch.data.loader import DataLoader
    meta = read_meta(directory)
    if meta is None:
        raise FileNotFoundError(f"no {META_NAME} under {directory!r} "
                                f"(prepare_mlm_shards writes one)")
    files = {k: sorted(globlib.glob(os.path.join(globlib.escape(directory),
                                                 f"{k}-*.npy")))
             for k in ("tokens", "token_types")}
    return DataLoader(files=files, batch_size=batch_size, **loader_kw), meta


def mask_batch(tokens: np.ndarray, rng: np.random.Generator, *,
               vocab_size: int, max_predictions: int,
               mask_prob: float = 0.15) -> Dict[str, np.ndarray]:
    """One dynamic-masking draw over a raw ``[B, L]`` token batch.

    BERT's 80/10/10 recipe with the reference's fixed-slot layout: per row,
    ``min(max_predictions, round(mask_prob * n_maskable))`` positions are
    drawn without replacement among non-special tokens; 80% become
    ``MASK_ID``, 10% a uniform random word id, 10% stay. Unused slots carry
    weight 0 (and position 0, which the loss ignores through the weight).
    Returns ``{"tokens", "mlm_positions", "mlm_targets", "mlm_weights"}``
    with ``tokens`` a masked COPY of the input.
    """
    if not 0.0 < mask_prob <= 1.0:
        raise ValueError(f"mask_prob {mask_prob} out of (0, 1]")
    batch, length = tokens.shape
    P = max_predictions
    maskable = tokens >= N_SPECIAL
    # Rank positions by a random key, non-maskable pushed to the end: the
    # first k columns of the argsort are a uniform sample w/o replacement.
    keys = rng.random((batch, length))
    keys[~maskable] = np.inf
    order = np.argsort(keys, axis=1)[:, :P].astype(np.int32)    # [B, P]
    n_maskable = maskable.sum(axis=1)
    k = np.minimum(np.maximum(np.rint(mask_prob * n_maskable), 1), P)
    k = np.minimum(k, n_maskable).astype(np.int32)              # rows can be all-pad
    slot = np.arange(P)[None, :]
    weights = (slot < k[:, None]).astype(np.float32)            # [B, P]
    positions = np.where(weights > 0, order, 0).astype(np.int32)

    rows = np.arange(batch)[:, None]
    targets = tokens[rows, positions].astype(np.int32)
    u = rng.random((batch, P))
    replacement = np.where(
        u < 0.8, MASK_ID,
        np.where(u < 0.9,
                 rng.integers(N_SPECIAL, vocab_size, size=(batch, P)),
                 targets)).astype(tokens.dtype)
    masked = tokens.copy()
    live = weights > 0
    # Dead slots write the original value back at position 0 — a no-op, so no
    # scatter mask is needed.
    masked[rows, positions] = np.where(live, replacement, targets)
    return {"tokens": masked, "mlm_positions": positions,
            "mlm_targets": targets, "mlm_weights": weights}


class MLMBatcher:
    """Dynamic-masking view over a :class:`~autodist_tpu_torch.data.DataLoader`.

    Wraps a loader serving raw ``{"tokens", "token_types"}`` batches (the
    :func:`prepare_mlm_shards` files) and yields full MLM batches. Masking is
    deterministic under ``seed`` given the loader's batch order (the loader's
    own shuffle is seeded too, so a fixed (loader seed, batcher seed) pair
    replays an identical stream — the property the determinism test pins).
    """

    def __init__(self, loader, *, vocab_size: int, max_predictions: int = 20,
                 mask_prob: float = 0.15, seed: int = 0):
        self._loader = loader
        self.vocab_size = vocab_size
        self.max_predictions = max_predictions
        self.mask_prob = mask_prob
        self._rng = np.random.Generator(np.random.PCG64(seed))

    def next(self) -> Dict[str, np.ndarray]:
        raw = self._loader.next()
        out = mask_batch(raw["tokens"], self._rng, vocab_size=self.vocab_size,
                         max_predictions=self.max_predictions,
                         mask_prob=self.mask_prob)
        out["token_types"] = raw.get(
            "token_types", np.zeros_like(raw["tokens"]))
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()
