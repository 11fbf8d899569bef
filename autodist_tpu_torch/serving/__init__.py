"""Production serving plane: continuous-batching inference on the zero-copy
wire (the port of ``autodist_tpu/serving``).

Five layers, one subsystem:

- :mod:`autodist_tpu_torch.serving.batcher` — request queue + continuous/static
  batching loop (torch-free host core; ``ServeConfig`` knobs, bucketed prompt
  padding, decode-step-granularity admission, early-exit slot reuse, paged
  admission gating via the engine's ``can_admit`` hook).
- :mod:`autodist_tpu_torch.serving.runtime` — model runtime adapters:
  ``LMEngine`` drives the Transformer LM's prefill+decode KV-cache path with
  a shared multi-slot dense cache written in place; ``ApplyEngine`` applies
  the stateless classifier/recommender families over padded batches.
- :mod:`autodist_tpu_torch.serving.paged` — ``PagedLMEngine``: the dense
  ``[max_batch, max_len]`` slab re-cut into ``[num_pages, page_len]`` pages
  with lazy allocation, completion-time free, and a shared-prefix page cache
  (copy-on-write at the first divergent page) — same bit-exact outputs,
  admission gated on free pages instead of slots.
- :mod:`autodist_tpu_torch.serving.transport` — ``InferenceServer`` /
  ``ServeClient`` speaking ``generate``/``infer``/``stats``/``status``/
  ``ping`` opcodes on the scatter-gather wire (the JAX package's frames,
  request-id replay dedup for the fleet router).
- :mod:`autodist_tpu_torch.serving.router` — ``Router`` / ``RouterServer``: one
  front door over N replicas (least-loaded spread, typed ``ServeBusy``
  shedding, idempotent replay around a dead replica, ``serve_p99_burn``
  alert-driven drain + scale-out on the coordinator's respawn budget).

SLO metrics (``serve.latency_s.*`` ms-bucket histograms, queue/batch gauges,
request counters, ``serve.router.*`` / ``serve.kv.*`` fleet families) ride
:mod:`autodist_tpu_torch.telemetry`; spans appear in the cluster trace as
``serve.*``.

Typical wiring (see ``autodist_tpu_torch/examples/serve_lm.py``); the
engines serve on the device the params live on::

    config = serving.ServeConfig.from_env(max_batch=8)
    engine = serving.LMEngine(model, params, config)
    server = serving.InferenceServer(serving.Batcher(engine, config))
    client = serving.ServeClient("%s:%d" % server.address)
    tokens, timing = client.generate(prompt, max_new_tokens=32)

Fleet wiring (paged replicas behind the router)::

    def replica():
        cfg = serving.ServeConfig.from_env(page_len=16)
        engine = serving.PagedLMEngine(model, params, cfg)
        return serving.InferenceServer(serving.Batcher(engine, cfg))
    front = serving.RouterServer(serving.Router(replica, n_replicas=2))
    client = serving.ServeClient(front.address)   # unchanged client
"""

from autodist_tpu_torch.serving.batcher import (ApplyBatcher, Batcher, ServeBusy,
                                                ServeConfig, ServeError,
                                                ServeRequest, bucket_for,
                                                default_buckets, pad_prompt)
from autodist_tpu_torch.serving.paged import (PagedLMEngine, PageAllocator,
                                              page_buckets)
from autodist_tpu_torch.serving.router import Replica, Router, RouterServer
from autodist_tpu_torch.serving.runtime import ApplyEngine, LMEngine
from autodist_tpu_torch.serving.transport import InferenceServer, ServeClient

__all__ = [
    "ServeConfig", "ServeError", "ServeBusy", "ServeRequest",
    "Batcher", "ApplyBatcher", "LMEngine", "ApplyEngine", "PagedLMEngine",
    "PageAllocator", "InferenceServer", "ServeClient",
    "Replica", "Router", "RouterServer",
    "bucket_for", "default_buckets", "pad_prompt", "page_buckets",
]
