"""NCF (NeuMF) recommender benchmark, the sparse-heavy workload (the port's
counterpart of ``examples/benchmark/ncf.py``).

MovieLens-20m-scale NeuMF (138,000 users, 27,000 items, f32) with row-sparse
embedding gradients under ``Parallax`` (the tables to PS, the dense towers to
the all-reduce; ``--strategy`` names another builder of
:mod:`autodist_tpu_torch.strategy`), Adam 1e-3, a global batch of 65,536.
Input is synthetic and resident on the card, or a MovieLens-format ratings
file (``--ratings``: ``user,item,rating,timestamp`` CSV or ml-1m's ``::``
format) filtered, zero-indexed and split leave-last-out, streamed a sampled
epoch at a time (fresh negatives each epoch) through the native loader and
the device feed; after training it prints HR@10 and NDCG@10 on the held-out
items.

    python -m autodist_tpu_torch.examples.benchmark.ncf                      # the card
    python -m autodist_tpu_torch.examples.benchmark.ncf --ratings ratings.csv --steps 50
    # on the host:
    python -m autodist_tpu_torch.examples.benchmark.ncf --device cpu --batch_size 256 \\
        --steps 2

MFU is per card against the H100's 989 TFLOP/s from a ``FlopCounterMode``
count of the step's matmuls (the gathers are not counted); on the host it
is not measured.
"""

import argparse
import dataclasses
from typing import Optional, Sequence

import torch

from autodist_tpu_torch import AutoDist
from autodist_tpu_torch import strategy as strategies
from autodist_tpu_torch.data import movielens
from autodist_tpu_torch.examples.benchmark.common import card_mfu, is_rank0, timed_steps
from autodist_tpu_torch.models import ncf
from autodist_tpu_torch.runner import shutdown
from autodist_tpu_torch.utils import flops as flops_util
from autodist_tpu_torch.utils.device import resolve_device

DEFAULT_BATCH = 65536


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=110)
    parser.add_argument("--batch_size", type=int, default=0,
                        help=f"global batch; 0 = {DEFAULT_BATCH} whatever the device count")
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--resource_spec", type=str, default=None)
    parser.add_argument("--strategy", default="Parallax",
                        help="a builder of autodist_tpu_torch.strategy, with its defaults")
    parser.add_argument("--ratings", type=str, default=None,
                        help="train on a MovieLens-format ratings file (user,item,rating,"
                             "timestamp CSV or ml-1m ::-separated .dat) with the "
                             "reference's filter/zero-index/leave-last-out protocol, then "
                             "report HR@10 / NDCG@10 on the held-out items")
    parser.add_argument("--num_neg", type=int, default=4,
                        help="training negatives per positive (--ratings)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:$LOCAL_RANK or cuda:0; "
                             "'cpu' for the host)")
    return parser.parse_args(argv)


@dataclasses.dataclass
class Bench:
    """What :func:`build` made: the step, a batch source, and the ratings."""
    args: argparse.Namespace
    model: ncf.NeuMF
    loss_fn: object
    step: object
    next_batch: object
    batch_size: int
    example: dict
    data: Optional[movielens.MovieLensData] = None
    feed: object = None

    def close(self):
        if self.feed is not None:
            self.feed.close()       # stop the producer (it would keep building epochs)


def build(args) -> Bench:
    """The training step (``AutoDist.function`` with Adam 1e-3) and its batch
    source, as ``main`` runs them."""
    device = resolve_device(args.device)
    batch_size = args.batch_size or DEFAULT_BATCH
    cfg, data = ncf.NeuMFConfig(), None
    if args.ratings:
        data = movielens.load_ratings(args.ratings)
        cfg = ncf.NeuMFConfig(num_users=data.num_users, num_items=data.num_items)
        batch_size = min(batch_size, data.num_train * (1 + args.num_neg))
    model, params = ncf.init_params(cfg, seed=0, device=device)
    example = ncf.synthetic_batch(cfg, batch_size)
    loss_fn = ncf.make_loss_fn(model)
    ad = AutoDist(args.resource_spec, getattr(strategies, args.strategy)(), device=device)
    step = ad.function(loss_fn, params, lambda p: torch.optim.Adam(p, lr=1e-3),
                       example_batch=example)
    bench = Bench(args, model, loss_fn, step, None, batch_size, example, data)
    if data is not None:
        # The reference's per-epoch protocol: each epoch samples fresh
        # uniform negatives (a new seed) and streams its batches through the
        # native loader; sample_training_epoch already shuffles.
        from autodist_tpu_torch.data.loader import DataLoader, device_prefetch

        def epochs():
            seed = 0
            while True:
                loader = DataLoader(
                    arrays=movielens.sample_training_epoch(data, args.num_neg, seed=seed),
                    batch_size=batch_size, shuffle=False)
                try:
                    for _ in range(max(1, loader.n_rows // batch_size)):
                        yield loader.next()
                finally:
                    loader.close()
                seed += 1

        bench.feed = device_prefetch(epochs(), step.runner, depth=2)
        bench.next_batch = lambda: next(bench.feed)
    else:
        # The synthetic batch stays on the card (measure the card, not the link).
        resident = step.runner.shard_batch(example)
        bench.next_batch = lambda: resident
    return bench


def evaluate(bench: Bench, k: int = 10):
    """``(HR@k, NDCG@k)`` of the trained model under the reference's
    protocol: each user's held-out item ranked among unseen negatives."""
    step, model = bench.step, bench.model
    device = step.runner.device
    params = step.runner.logical_params(step.get_state())

    def score(users, items):
        with torch.no_grad():
            return ncf.apply(model, params, torch.as_tensor(users).to(device),
                             torch.as_tensor(items).to(device)).cpu().numpy()

    negatives = movielens.sample_eval_negatives(bench.data)  # may clamp on tiny corpora
    hr, ndcg = movielens.hit_rate_and_ndcg(score, bench.data, k=k, batch_users=512,
                                           negatives=negatives)
    print(f"ncf eval: HR@{k}={hr:.4f} NDCG@{k}={ndcg:.4f} ({len(bench.data.eval_users)} "
          f"users, {negatives.shape[1]} negatives each)")
    return hr, ndcg


def train(bench: Bench) -> dict:
    """``--steps`` steps: examples/s over the whole mesh after one warm-up
    step, MFU and peak memory per card; with ``--ratings`` also HR@10 and
    NDCG@10."""
    args, step = bench.args, bench.step
    avg, final, peak = timed_steps(step, bench.next_batch, bench.batch_size, args.steps,
                                   args.log_every)
    if is_rank0():
        print(f"ncf: final loss {final:.4f}, {avg:.1f} examples/sec"
              + (f", max_memory_allocated {peak} bytes" if peak is not None else ""))
    result = {"model": "ncf", "strategy": args.strategy,
              "source": "ratings" if bench.data is not None else "synthetic",
              "batch_size": bench.batch_size, "examples_per_sec": avg, "final_loss": final,
              "max_memory_allocated": peak}
    if bench.data is not None:
        result["hr"], result["ndcg"] = evaluate(bench)
    result["flops_per_step"], result["mfu"] = card_mfu(
        lambda: flops_util.loss_and_grad_flops(
            bench.loss_fn, step.runner.logical_params(step.get_state()),
            step.runner.shard_batch(bench.example, accumulation=1)),
        avg / bench.batch_size, step.runner.device)
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    bench = build(parse_args(argv))
    try:
        return train(bench)
    finally:
        bench.close()


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
