"""Text-corpus ingestion: whitespace-tokenized files -> token shards (the
port's copy of ``autodist_tpu/data/text_corpus.py``, host numpy only).

The reference's lm1b pipeline consumed the REAL 1B-word-benchmark corpus
(``examples/lm1b/lm1b_train.py:26-50``): text lines split on whitespace,
flattened into one continuous word stream, cut into ``num_steps``(+1)-token
windows, with word->id lookup through the published vocab file
(``1b_word_vocab.txt``; ``language_model.py:108-111`` — word in column 0,
out-of-vocabulary words hashed into ``oov_bucket_size`` extra ids).

This module is that ingestion: a STREAMING tokenizer that reads the
corpus files once, windows the word stream, and writes ``tokens-*.npy``
shards — the exact files the native ``DataLoader(files=...)`` memory-maps and
``examples/lm1b/lm1b_train.py --data_dir`` trains from. Corpus size is
unbounded: rows are flushed shard-by-shard, nothing materializes beyond one
shard buffer. The vocab side accepts the published file format
(:func:`load_vocab`) or builds one from the corpus by frequency
(:func:`build_vocab`).

OOV hashing uses crc32 (stable across processes/runs — Python's ``hash`` is
salted per process, which would tokenize the same corpus differently on
chief and workers).
"""

import glob as globlib
import logging
import os
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np


_log = logging.getLogger("autodist_tpu_torch")

PathsSpec = Union[str, Sequence[str]]


class Vocabulary:
    """word -> id mapping with hashed out-of-vocabulary buckets.

    ids ``[0, n_words)`` are the known words; ids ``[n_words,
    n_words + oov_buckets)`` are OOV buckets (crc32 of the word, mod buckets)
    — the reference's ``StaticVocabularyTable`` semantics
    (``language_model.py:108-111``). ``vocab_size`` (= embedding rows needed)
    includes the buckets.
    """

    def __init__(self, words: Sequence[str], oov_buckets: int = 1):
        if oov_buckets < 1:
            raise ValueError("oov_buckets must be >= 1 (unknown words need "
                             "somewhere to go)")
        self._ids: Dict[str, int] = {}
        for w in words:
            # First occurrence wins, like a lookup table built top-down.
            self._ids.setdefault(w, len(self._ids))
        self.n_words = len(self._ids)
        self.oov_buckets = oov_buckets
        self.vocab_size = self.n_words + oov_buckets

    def lookup(self, word: str) -> int:
        wid = self._ids.get(word)
        if wid is not None:
            return wid
        return self.n_words + zlib.crc32(word.encode("utf-8")) % self.oov_buckets

    def __len__(self) -> int:
        return self.vocab_size


def load_vocab(path: str, oov_buckets: int = 1,
               max_size: Optional[int] = None) -> Vocabulary:
    """Read a vocab file — one entry per line, word in the FIRST whitespace
    column (the published ``1b_word_vocab.txt`` carries ``word count`` pairs).
    ``max_size`` truncates to the top entries (the file is frequency-sorted)."""
    words: List[str] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            cols = line.split()
            if not cols:
                continue
            words.append(cols[0])
            if max_size is not None and len(words) >= max_size:
                break
    if not words:
        raise ValueError(f"vocab file {path!r} has no entries")
    return Vocabulary(words, oov_buckets)


def _resolve_paths(files: PathsSpec) -> List[str]:
    if isinstance(files, str):
        paths = sorted(globlib.glob(files)) if any(c in files for c in "*?[") \
            else [files]
    else:
        paths = list(files)
    if not paths:
        raise ValueError(f"no corpus files match {files!r}")
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    return paths


def _words(paths: List[str]) -> Iterator[str]:
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                yield from line.split()


def build_vocab(files: PathsSpec, max_size: int,
                oov_buckets: int = 1) -> Vocabulary:
    """Build a frequency-sorted vocabulary from the corpus itself (one
    streaming pass) — for corpora without a published vocab file. Ties break
    by first appearance, so the result is deterministic."""
    if max_size < 1:
        raise ValueError("max_size must be >= 1")
    counts: Dict[str, int] = {}
    for w in _words(_resolve_paths(files)):
        counts[w] = counts.get(w, 0) + 1
    # Python's sort is stable and dict order is insertion order, so sorting by
    # count alone already breaks ties by first appearance.
    top = sorted(counts, key=lambda w: -counts[w])[:max_size]
    return Vocabulary(top, oov_buckets)


def tokenize_to_shards(files: PathsSpec, vocab: Vocabulary, directory: str,
                       seq_len: int, rows_per_shard: int = 1 << 16,
                       stride: Optional[int] = None,
                       key: str = "tokens") -> List[str]:
    """Stream the corpus into ``<key>-NNNNN.npy`` shards of
    ``[rows, seq_len + 1]`` int32 windows under ``directory``; returns the
    shard paths (the ``DataLoader(files=...)`` /
    ``lm1b_train.py --data_dir`` input).

    The word stream is continuous across lines and files (the reference
    flat-mapped lines into one stream before windowing). ``stride`` defaults
    to ``seq_len + 1`` — contiguous non-overlapping windows, every token
    trained on once per epoch; ``stride=1`` reproduces the reference's
    every-word-starts-a-window dataset (``lm1b_train.py:43``), trading disk
    for sample diversity; ``stride > seq_len + 1`` SUBSAMPLES, skipping the
    tokens between windows. A tail shorter than a full window is dropped
    (static shapes only). Memory use is one shard buffer, however large the
    corpus. Pre-existing ``<key>-*.npy`` shards in ``directory`` are swept
    first (re-preparing a smaller corpus must not leave stale shards)."""
    if seq_len < 1:
        raise ValueError("seq_len must be >= 1")
    if rows_per_shard < 1:
        raise ValueError("rows_per_shard must be >= 1")
    width = seq_len + 1
    stride = width if stride is None else stride
    if stride < 1:
        raise ValueError("stride must be >= 1")
    os.makedirs(directory, exist_ok=True)
    for stale in globlib.glob(os.path.join(globlib.escape(directory),
                                           f"{globlib.escape(key)}-*.npy")):
        os.remove(stale)

    paths: List[str] = []
    buf = np.empty((rows_per_shard, width), np.int32)
    n_buf = 0
    window: List[int] = []
    n_rows = 0

    def flush():
        nonlocal n_buf
        if n_buf == 0:
            return
        path = os.path.join(directory, f"{key}-{len(paths):05d}.npy")
        np.save(path, buf[:n_buf])
        paths.append(path)
        n_buf = 0

    skip = 0  # words to drop before the next window starts (stride > width)
    for word in _words(_resolve_paths(files)):
        if skip:
            skip -= 1
            continue
        window.append(vocab.lookup(word))
        if len(window) == width:
            buf[n_buf] = window
            n_buf += 1
            n_rows += 1
            del window[:min(stride, width)]
            skip = stride - width if stride > width else 0
            if n_buf == rows_per_shard:
                flush()
    flush()
    if not paths:
        raise ValueError(
            f"corpus has fewer than seq_len + 1 = {width} words; no windows")
    # Sidecar metadata: the training run is a separate process and must size
    # its embedding to cover every id the shards contain — a too-small --vocab
    # would otherwise fail only when an OOV-bucket id gathers out of range.
    write_meta(directory, vocab_size=vocab.vocab_size, seq_len=seq_len,
               rows=n_rows, stride=stride, oov_buckets=vocab.oov_buckets,
               key=key)
    _log.info("Tokenized corpus -> %d rows of %d tokens across %d shards "
                 "in %s (vocab %d incl. %d OOV bucket(s))", n_rows, width,
                 len(paths), directory, vocab.vocab_size, vocab.oov_buckets)
    return paths


def write_meta(directory: str, *, vocab_size: int, seq_len: int, rows: int,
               stride: int, oov_buckets: int, key: str = "tokens") -> None:
    """Write the shard sidecar (one schema, shared by every shard writer —
    the tokenizer here and e.g. lm1b's synthetic-corpus prep)."""
    import json
    with open(os.path.join(directory, f"{key}-meta.json"), "w") as f:
        json.dump({"vocab_size": vocab_size, "seq_len": seq_len,
                   "rows": rows, "stride": stride,
                   "oov_buckets": oov_buckets}, f, indent=1)


def read_meta(directory: str, key: str = "tokens") -> Optional[dict]:
    """The sidecar metadata :func:`write_meta` wrote (None when the shards
    came from a writer without one)."""
    import json
    path = os.path.join(directory, f"{key}-meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
