"""MovieLens-format preprocessing for the NCF recommender — real data in (the
port's copy of ``autodist_tpu/data/movielens.py``: host numpy, the same draws in
the same order, so one seed gives the JAX package's arrays).

The reference's recommendation pipeline (~3.5k LoC under
``examples/benchmark/utils/recommendation/``) downloaded MovieLens, coerced it
to a standard CSV, then (``data_preprocessing.py:52-120``):

1. filtered out users with fewer than 20 ratings,
2. zero-indexed user and item ids,
3. sorted by (user, timestamp) and held out each user's LAST item as the
   evaluation positive (leave-last-out),
4. sampled training negatives per epoch and 100 evaluation negatives per
   user for the HR@K / NDCG@K protocol (``ncf_common.py``).

This module is that pipeline offline (this environment has no
egress; point it at a ratings file you already have): numpy parsing of both
the standard ``user,item,rating,timestamp`` CSV and the raw ml-1m
``user::item::rating::timestamp`` format, the same filter/zero-index/
leave-last-out transforms, per-epoch uniform training negatives (the classic
NCF protocol — false negatives allowed in training, excluded in eval), and
row-aligned ``.npy`` shards (``save_shards``) that stream through the native
DataLoader. ``hit_rate_and_ndcg`` scores a trained NeuMF with the reference's
eval protocol.
"""

import dataclasses
import logging
import os
from typing import Callable, Dict, Optional

import numpy as np

from autodist_tpu_torch.data.loader import save_shards

_log = logging.getLogger("autodist_tpu_torch")

MIN_NUM_RATINGS = 20          # reference rconst.MIN_NUM_RATINGS
NUM_EVAL_NEGATIVES = 100      # reference rconst.NUM_EVAL_NEGATIVES


@dataclasses.dataclass(frozen=True)
class MovieLensData:
    """Preprocessed interactions, zero-indexed and leave-last-out split."""

    num_users: int
    num_items: int
    train_users: np.ndarray    # [N] int32, sorted by (user, timestamp)
    train_items: np.ndarray    # [N] int32
    eval_users: np.ndarray     # [num_users] int32 (one row per kept user)
    eval_items: np.ndarray     # [num_users] int32 — the held-out LAST item

    @property
    def num_train(self) -> int:
        return len(self.train_users)


def load_ratings(path: str, min_ratings: int = MIN_NUM_RATINGS) -> MovieLensData:
    """Parse + filter + zero-index + sort + leave-last-out split.

    Accepts the standard ``user_id,item_id,rating,timestamp`` CSV (with or
    without a header) or the raw ml-1m ``::``-separated ``.dat`` format —
    the same two shapes the reference's ``_transform_csv`` normalized
    (``movielens.py:159-180``).
    """
    with open(path) as f:
        first = f.readline()
    sep = "::" if "::" in first else ","
    skip = 0 if first.split(sep)[0].strip().isdigit() else 1
    source = path
    if sep == "::":
        # np.loadtxt needs a single-char delimiter; normalize ml-1m's "::"
        # in memory (the 1m file is ~24 MB — cheap).
        import io
        with open(path) as f:
            source = io.StringIO(f.read().replace("::", ","))
    raw = np.loadtxt(source, delimiter=",", skiprows=skip, usecols=(0, 1, 3),
                     dtype=np.int64, ndmin=2)
    users, items, stamps = raw[:, 0], raw[:, 1], raw[:, 2]

    # 1) drop users with < min_ratings interactions (reference filter).
    uniq, inverse, counts = np.unique(users, return_inverse=True,
                                      return_counts=True)
    keep = counts[inverse] >= min_ratings
    users, items, stamps = users[keep], items[keep], stamps[keep]
    if len(users) == 0:
        raise ValueError(
            f"{path}: no user has >= {min_ratings} ratings; lower min_ratings")

    # 2) zero-index users and items (largest id = count - 1).
    uniq_users, users = np.unique(users, return_inverse=True)
    uniq_items, items = np.unique(items, return_inverse=True)

    # 3) sort by (user, timestamp) so each user's slice is contiguous and the
    # eval positive is simply the slice's last element.
    order = np.lexsort((stamps, users))
    users, items = users[order].astype(np.int32), items[order].astype(np.int32)

    # Leave-last-out: the final interaction per user is the eval positive.
    last_of_user = np.r_[users[1:] != users[:-1], True]
    eval_users = users[last_of_user]
    eval_items = items[last_of_user]
    data = MovieLensData(
        num_users=len(uniq_users), num_items=len(uniq_items),
        train_users=users[~last_of_user], train_items=items[~last_of_user],
        eval_users=eval_users, eval_items=eval_items)
    _log.info(
        "MovieLens %s: %d ratings -> %d train + %d eval positives, "
        "%d users x %d items (min_ratings=%d)", os.path.basename(path),
        len(raw), data.num_train, len(eval_users), data.num_users,
        data.num_items, min_ratings)
    return data


def sample_training_epoch(data: MovieLensData, num_neg: int = 4,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """One epoch of training examples: every positive plus ``num_neg``
    uniform-random negatives per positive (labels 1/0), shuffled.

    Uniform sampling MAY produce false negatives — the classic NCF training
    protocol the reference used (``stat_utils.py`` sampled with replacement);
    the eval negatives below are the ones that exclude seen items."""
    rng = np.random.RandomState(seed)
    n = data.num_train
    users = np.concatenate([data.train_users,
                            np.repeat(data.train_users, num_neg)])
    items = np.concatenate([data.train_items,
                            rng.randint(0, data.num_items, size=n * num_neg,
                                        dtype=np.int64).astype(np.int32)])
    labels = np.concatenate([np.ones(n, np.float32),
                             np.zeros(n * num_neg, np.float32)])
    perm = rng.permutation(len(users))
    return {"users": users[perm], "items": items[perm], "labels": labels[perm]}


def sample_eval_negatives(data: MovieLensData,
                          num_negatives: int = NUM_EVAL_NEGATIVES,
                          seed: int = 0) -> np.ndarray:
    """[num_users, num_negatives] items the user has NOT interacted with
    (train positives + the eval positive excluded) — the HR@K candidates."""
    rng = np.random.RandomState(seed)
    seen = {}
    for u, i in zip(data.train_users, data.train_items):
        seen.setdefault(int(u), set()).add(int(i))
    for u, i in zip(data.eval_users, data.eval_items):
        seen.setdefault(int(u), set()).add(int(i))
    # Small corpora cannot supply the full protocol count of DISTINCT unseen
    # items; clamp to the worst-case feasible pool (comparable across users)
    # rather than failing — MovieLens-scale data never clamps.
    feasible = min(data.num_items - len(seen[int(u)])
                   for u in data.eval_users)
    if feasible < 1:
        raise ValueError(
            "some user has interacted with every item; no eval negatives "
            "exist")
    if feasible < num_negatives:
        _log.warning(
            "Eval negatives clamped %d -> %d (smallest unseen-item pool "
            "across users)", num_negatives, feasible)
        num_negatives = feasible
    out = np.empty((len(data.eval_users), num_negatives), np.int32)
    for row, u in enumerate(data.eval_users):
        excluded = set(seen[int(u)])  # one copy per user; mutated below
        picked = []
        while len(picked) < num_negatives:
            cand = rng.randint(0, data.num_items,
                               size=2 * (num_negatives - len(picked)))
            for c in cand:
                if c not in excluded:
                    picked.append(c)
                    excluded.add(int(c))  # negatives are distinct
                    if len(picked) == num_negatives:
                        break
        out[row] = picked
    return out


def write_training_shards(data: MovieLensData, directory: str,
                          num_neg: int = 4, rows_per_shard: int = 1 << 20,
                          seed: int = 0) -> Dict[str, list]:
    """Materialize one sampled epoch as row-aligned ``.npy`` shards for
    ``DataLoader(files=...)`` (re-run with a new ``seed`` per epoch, like the
    reference's per-epoch negative regeneration)."""
    return save_shards(sample_training_epoch(data, num_neg, seed), directory,
                       rows_per_shard=rows_per_shard)


def hit_rate_and_ndcg(score_fn: Callable, data: MovieLensData, k: int = 10,
                      num_negatives: int = NUM_EVAL_NEGATIVES, seed: int = 0,
                      batch_users: Optional[int] = None,
                      negatives: Optional[np.ndarray] = None):
    """HR@k and NDCG@k under the reference's protocol: rank each user's held
    -out positive among ``num_negatives`` unseen items.

    ``score_fn(users, items) -> scores`` takes flat int32 numpy arrays and
    returns anything ``np.asarray`` reads (e.g. a function that runs the
    torch model on the card and copies its scores back). ``negatives``
    (``[num_users, n]``) overrides the sampling — pass the array from
    :func:`sample_eval_negatives` to also know the post-clamp count. Returns
    ``(hit_rate, ndcg)``.
    """
    if negatives is None:
        negatives = sample_eval_negatives(data, num_negatives, seed)
    n_users = len(data.eval_users)
    cands = np.concatenate([data.eval_items[:, None], negatives], axis=1)
    n_cand = cands.shape[1]
    hits = ndcg = 0.0
    step = batch_users or n_users
    for lo in range(0, n_users, step):
        cu = data.eval_users[lo:lo + step]
        ci = cands[lo:lo + step]
        flat_u = np.repeat(cu, n_cand).astype(np.int32)
        flat_i = ci.reshape(-1).astype(np.int32)
        scores = np.asarray(score_fn(flat_u, flat_i)).reshape(len(cu), n_cand)
        # Tie handling = EXACT expectation under uniform tie placement: with
        # s strictly-better negatives and t ties, the positive's rank is
        # uniform over [s, s+t], so HR@k averages the indicator and NDCG@k
        # averages 1/log2(rank+2) over that window. Strictly-greater alone
        # would hand a CONSTANT scorer rank 0 (perfect metrics for a model
        # that learned nothing); a mid-rank point estimate still gives
        # all-or-nothing credit through the rank<k threshold.
        s = (scores[:, 1:] > scores[:, :1]).sum(axis=1)           # [U]
        t = (scores[:, 1:] == scores[:, :1]).sum(axis=1)          # [U]
        pos = np.arange(n_cand)[None, :]                          # [1, C]
        in_window = (pos >= s[:, None]) & (pos <= (s + t)[:, None])
        gain = np.where(pos < k, 1.0 / np.log2(pos + 2), 0.0)
        width = (t + 1).astype(np.float64)
        hits += ((in_window & (pos < k)).sum(axis=1) / width).sum()
        ndcg += ((in_window * gain).sum(axis=1) / width).sum()
    return hits / n_users, ndcg / n_users
