"""The end of a distributed entry point (``runner.shutdown``): every
runner's captured ``run_many`` graphs are released while the process group
is still up, and only then is the group destroyed. On the cards a graph
captured with NCCL collectives inside holds their communicator, and NCCL's
destroy waits for it: destroying the group first hung a 4-card run after
its result line.

No graph is captured on the host (``run_many`` loops there), so the test
stands a recording graph in for a capture and holds the order over 2 gloo
ranks spawned as tests/test_torch_data_parallel.py spawns them (torch and
the port only), each rank exiting 0 within the spawn's limit. The release
also empties the runner's cache, after which ``run_many`` runs again.
"""

import json
import pathlib
import sys

import numpy as np
import torch

import autodist_tpu_torch
from test_torch_ring_attention import join_gloo_group, ranks_running

NODES = {"nodes": [{"address": "localhost", "gpus": [0, 1]}]}
ROWS = 8


def _loss(params, batch):
    return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()


def _batches(n):
    rng = np.random.RandomState(0)
    return [{"x": torch.tensor(rng.randn(ROWS, 4).astype(np.float32)),
             "y": torch.tensor(rng.randn(ROWS, 1).astype(np.float32))} for _ in range(n)]


class _RecordingGraph:
    """Stands in for a captured ``torch.cuda.CUDAGraph``: records whether the
    process group was still up when it was reset."""

    def __init__(self, events):
        self.events = events

    def reset(self):
        import torch.distributed as dist
        self.events.append(("reset", dist.is_initialized()))


def _worker(workdir: pathlib.Path):
    import torch.distributed as dist
    from autodist_tpu_torch import AllReduce, AutoDist, runner as runner_lib

    join_gloo_group()
    rank = dist.get_rank()
    params = {"w": torch.zeros(4, 1)}
    runner = AutoDist(resource_info=NODES, strategy_builder=AllReduce(),
                      device="cpu").create_distributed_session(
        _loss, params, lambda p: torch.optim.SGD(p, lr=0.1))
    state = runner.init(params)
    losses = [runner.run_many(state, _batches(2))[1].tolist()]
    events = []

    def stand_in():
        runner._graphs[("stand-in",)] = runner_lib._CapturedBlock(
            _RecordingGraph(events), None, None, {}, ())
        runner._graph_pool = object()
        runner_lib._GRAPHED.add(runner)

    stand_in()
    runner.release_graphs()
    released = not runner._graphs and runner._graph_pool is None \
        and runner not in runner_lib._GRAPHED
    losses.append(runner.run_many(state, _batches(2))[1].tolist())
    stand_in()
    runner_lib.shutdown()
    result = {"events": events, "released": released, "graphs_left": len(runner._graphs),
              "group_left": dist.is_initialized(), "losses": losses}
    (workdir / f"teardown_rank{rank}.json").write_text(json.dumps(result))


def test_shutdown_releases_graphs_before_destroying_the_group(tmp_path):
    with ranks_running(pathlib.Path(__file__), 2, "teardown", tmp_path) as wait:
        wait()
    for rank in range(2):
        got = json.loads((tmp_path / f"teardown_rank{rank}.json").read_text())
        # Both resets (release_graphs, then shutdown's) ran with the group up.
        assert got["events"] == [["reset", True], ["reset", True]]
        assert got["released"] and got["graphs_left"] == 0 and not got["group_left"]
        # run_many after a release: the next steps of the same state.
        assert len(got["losses"]) == 2 and got["losses"][0] != got["losses"][1]


def test_every_entry_point_destroys_its_group_through_shutdown():
    """No module of the port calls ``destroy_process_group`` but
    ``runner.shutdown``."""
    package = pathlib.Path(autodist_tpu_torch.__file__).parent
    callers = sorted(str(p.relative_to(package)) for p in package.rglob("*.py")
                     if "destroy_process_group" in p.read_text())
    assert callers == ["runner.py"]


if __name__ == "__main__":
    if sys.argv[1] == "teardown":
        _worker(pathlib.Path(sys.argv[2]))
