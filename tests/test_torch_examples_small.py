"""The port's four self-contained examples (autodist_tpu_torch.examples:
linear_regression, multiprocess_linear_regression, sentiment_classifier,
image_classifier) at a few steps on the host.

Where an example's weights and batches come from numpy seeds (linear
regression, the sentiment classifier), its losses are held against the JAX
example's own run (rtol 1e-5 for full-batch SGD; 1e-4 for Adam, whose
normalised update amplifies the two frameworks' summation orders, as in
tests/test_torch_autodist.py). The image classifier's weights come from each
package's own initializer, so it is held to training: its loss falls. The
two-process examples run over 2 gloo ranks in one spawn (the environment
torchrun sets): the multi-process linear regression against a hand-computed
single-process run (rtol 1e-6, as tests/test_multiprocess.py holds the JAX
one), and the sentiment classifier, whose table's gradient then crosses the
ranks as (indices, rows), against its one-process run (rtol 1e-4).
"""

import functools
import json
import pathlib
import sys

import numpy as np
import pytest

from autodist_tpu_torch.examples import (image_classifier, linear_regression,
                                         multiprocess_linear_regression, sentiment_classifier)
from test_torch_ring_attention import join_gloo_group, ranks_running

SENTIMENT_STEPS = 10


def _two_rank_worker(workdir: pathlib.Path):
    import torch.distributed as dist
    join_gloo_group()
    multiprocess_linear_regression.main(str(workdir / "mp_lr.json"), device="cpu")
    losses = sentiment_classifier.main(steps=SENTIMENT_STEPS, device="cpu")
    np.save(workdir / f"sentiment_rank{dist.get_rank()}.npy", np.array(losses))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("examples")
    with ranks_running(pathlib.Path(__file__), 2, "examples", workdir) as wait:

        @functools.cache
        def results():
            logs = wait()
            return workdir, logs

        yield results


def test_linear_regression_tracks_the_jax_example():
    import examples.linear_regression as jexample
    np.testing.assert_allclose(linear_regression.main(device="cpu"), jexample.main(),
                               rtol=1e-5)


def test_sentiment_routes_the_table_to_ps_and_tracks_the_jax_example():
    """The routing assertion holds inside ``main``; the losses follow JAX's."""
    import examples.sentiment_classifier as jexample
    got = sentiment_classifier.main(steps=SENTIMENT_STEPS, device="cpu")
    np.testing.assert_allclose(got, jexample.main(steps=SENTIMENT_STEPS), rtol=1e-4)


def test_image_classifier_trains_from_the_native_loader(capsys):
    losses = image_classifier.main(epochs=2, device="cpu")
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert "loader=native" in capsys.readouterr().out


def _hand_sgd():
    w = b = np.float32(0.0)
    losses = []
    for step in range(multiprocess_linear_regression.STEPS):
        batch = multiprocess_linear_regression.make_batch(step)
        err = batch["y"] - (batch["x"] * w + b)
        losses.append(float(np.mean(err ** 2)))
        dw = np.mean(-2.0 * batch["x"] * err, dtype=np.float32)
        db = np.mean(-2.0 * err, dtype=np.float32)
        w, b = w - np.float32(multiprocess_linear_regression.LR) * dw, \
            b - np.float32(multiprocess_linear_regression.LR) * db
    return float(w), float(b), losses


def test_two_rank_linear_regression_matches_a_hand_computed_run(two_ranks):
    workdir, _ = two_ranks()
    result = json.loads((workdir / "mp_lr.json").read_text())
    assert result["process_count"] == 2 and result["device_count"] == 2
    w, b, losses = _hand_sgd()
    np.testing.assert_allclose([result["w"], result["b"]], [w, b], rtol=1e-6)
    np.testing.assert_allclose(result["losses"], losses, rtol=1e-6)


def test_two_rank_sentiment_sends_the_sparse_wire(two_ranks):
    """Both ranks route the table to PS (asserted in ``main``) and report
    the global loss, which follows the one-process run."""
    workdir, logs = two_ranks()
    ranks = [np.load(workdir / f"sentiment_rank{r}.npy") for r in range(2)]
    np.testing.assert_array_equal(ranks[0], ranks[1])
    single = sentiment_classifier.main(steps=SENTIMENT_STEPS, device="cpu")
    np.testing.assert_allclose(ranks[0], single, rtol=1e-4)
    assert all("'embedding': 'ps_synchronizer'" in log for log in logs)


if __name__ == "__main__":
    if sys.argv[1] == "examples":
        _two_rank_worker(pathlib.Path(sys.argv[2]))
