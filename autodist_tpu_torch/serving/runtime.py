"""Model runtime adapters: the device half of the serving plane (the port of
``autodist_tpu/serving/runtime.py``).

:class:`LMEngine` drives the flagship Transformer LM's prefill+decode
KV-cache path (``models/transformer_lm.py``) for continuous batching:

- one SHARED decode cache of ``max_batch`` slots (``[B, max_len, H, hd]``
  per layer, :func:`~autodist_tpu_torch.models.transformer_lm.init_cache`),
  each slot an independent request parked at its own write frontier — the
  per-row ``pos_offset`` vector carries every slot's position through one
  decode call;
- PREFILL per prompt bucket (prompt right-padded to its bucket; the pad
  tail's K/V is masked until decode overwrites it position by position, so
  results equal an unpadded prefill), written IN PLACE into the slot's row of
  the shared cache: where the JAX package prefills a fresh ``[1, max_len]``
  cache and inserts the whole row (zeros beyond the bucket), the port's
  prefill writes ``[0, bucket)`` of the row and leaves the previous
  occupant's K/V beyond it; both tails sit behind the additive -1e9 mask;
- slot REUSE without scrubbing: a freed slot's stale K/V beyond the next
  occupant's frontier is never unmasked, and everything below it is
  overwritten by the occupant's own prefill.

Every call writes the existing cache tensors (the counterpart of the JAX
package's donation); a decode step allocates only its activations. JAX
bounds its compiled programs by bucket; the port runs eagerly and counts the
distinct step signatures it has run (:meth:`LMEngine.compiled_programs`),
held to the same bound.

:class:`ApplyEngine` is the stateless counterpart for the classifier /
recommender families: stack the gathered examples, pad the batch dim to a
power-of-two bucket, one ``apply``, split.

Each engine call enters ``torch.no_grad`` itself: the batcher drives it from
its own thread, and grad mode is per thread.
"""

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.models.common import lm_head_logits, make_keys, sample_logits
from autodist_tpu_torch.serving.batcher import (ServeConfig, bucket_for,
                                                default_buckets, pad_prompt)
from autodist_tpu_torch.utils.device import resolve_device


def params_device(params) -> torch.device:
    """The device the params live on (the engines serve there)."""
    for leaf in params.values():
        if torch.is_tensor(leaf):
            return leaf.device
    raise ValueError("params hold no tensor")


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples (the
    examples and outputs an apply engine carries)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


class LMEngine:
    """Continuous-batching decode engine over a Transformer LM.

    ``params`` are used where they are placed; the cache is made beside
    them. Position bookkeeping lives HERE, host-side (``pos[slot]`` = the
    cache row's write frontier = tokens so far for that request); the
    model's per-row ``pos_offset`` vector is fed from it every step.
    """

    def __init__(self, model, params, config: Optional[ServeConfig] = None):
        config = config or ServeConfig()
        self.model = model
        # This engine's own instance of the model's structure (built on the
        # meta device): ``functional_call`` swaps params into the module it
        # applies, so engines that share one module object could not run in
        # their batchers' threads at once (two replicas of one process).
        self._model = type(model)(model.config)
        self.config = config
        self._params = params
        self.device = params_device(params)
        cfg = model.config
        self.capacity = config.max_batch
        self.max_len = cfg.max_len
        self.buckets = tuple(b for b in (config.buckets or default_buckets(cfg.max_len))
                             if b <= cfg.max_len)
        if not self.buckets:
            raise ValueError(f"no pad bucket fits max_len {cfg.max_len}")
        self._sampling = (float(config.temperature), int(config.top_k), float(config.top_p))
        B = self.capacity
        self._pos = np.zeros(B, np.int64)       # per-slot write frontier
        self._active = np.zeros(B, bool)
        self._last = np.zeros(B, np.int64)      # last sampled token per slot
        self._signatures = set()                # distinct step shapes run
        self._cache = transformer_lm.init_cache(cfg, B, self.device)

    # ------------------------------------------------------------- sampling

    def _sample(self, logits: torch.Tensor, seeds: Optional[np.ndarray]) -> torch.Tensor:
        """Per-row sampling: every row draws from ITS request's seed, so a
        slot's token stream does not depend on who shares the batch."""
        temp, top_k, top_p = self._sampling
        if temp == 0.0:
            return sample_logits(logits)
        key = torch.as_tensor(np.asarray(seeds, np.int64)).to(logits.device)
        return sample_logits(logits, key, temp, top_k, top_p)

    # ------------------------------------------------------ engine interface

    def make_keys(self, seed: int, n: int) -> Optional[np.ndarray]:
        """The request's per-step sampling seeds, the schedule
        :func:`transformer_lm.generate` uses, so a served request equals
        ``generate()`` with its seed. Greedy engines return None."""
        if self._sampling[0] == 0.0:
            return None
        return make_keys(seed, n)

    @torch.no_grad()
    def admit(self, slot: int, prompt: np.ndarray, key: Optional[int]) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first sampled token.
        The prompt is right-padded to its bucket — pad K/V beyond the true
        length is masked now and overwritten by decode steps later, so
        padding never changes results."""
        plen = int(prompt.size)
        bucket = bucket_for(plen, self.buckets)
        self._signatures.add(("prefill", bucket))
        padded = torch.from_numpy(pad_prompt(prompt, bucket)).to(self.device).long()
        row = {k: (v[slot:slot + 1] if v.dim() else torch.zeros_like(v))
               for k, v in self._cache.items()}
        hidden = transformer_lm.apply(self._model, self._params, padded, pos_offset=0,
                                      decode=True, return_hidden=True, cache=row)
        lg = lm_head_logits(hidden[:, plen - 1], self._params,
                            tied=self.model.config.tied_output)
        first = int(self._sample(lg, None if key is None else [key])[0])
        self._pos[slot] = plen
        self._active[slot] = True
        self._last[slot] = first
        return first

    @torch.no_grad()
    def step(self, keys: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode step for EVERY slot (inactive rows compute garbage at
        position 0, masked for any later occupant); returns the [B] sampled
        tokens. Frontiers advance for active slots only."""
        self._signatures.add(("decode",))
        toks = torch.from_numpy(self._last).to(self.device)[:, None]
        pos = torch.from_numpy(self._pos).to(self.device)
        logits = transformer_lm.apply(self._model, self._params, toks, pos_offset=pos,
                                      decode=True, cache=self._cache)
        out = self._sample(logits[:, 0], keys).cpu().numpy().astype(np.int32)
        self._pos = np.where(self._active, self._pos + 1, 0)
        self._last = np.where(self._active, out, 0).astype(np.int64)
        return out

    def free(self, slot: int):
        """Release a slot (early exit / completion). No cache scrub: the next
        occupant's prefill overwrites [0, bucket) and its mask never reaches
        past its own frontier, and idle rows park their writes at position 0,
        which every prefill overwrites too."""
        self._active[slot] = False
        self._pos[slot] = 0
        self._last[slot] = 0

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    def kv_bytes(self) -> int:
        """Bytes of the shared KV cache."""
        return sum(v.numel() * v.element_size() for v in self._cache.values() if v.dim())

    def compiled_programs(self) -> Tuple[int, int]:
        """(prefill signatures, all signatures) run so far — the bound the
        bucketing exists for: at most ``len(buckets)`` prefills and one
        decode step (JAX counts its jitted programs, decode and insert
        included); tests pin it."""
        n_prefill = sum(sig[0] == "prefill" for sig in self._signatures)
        return n_prefill, len(self._signatures)


class ApplyEngine:
    """Stateless inference engine: ``apply_fn(params, stacked_examples) ->
    stacked_outputs`` over power-of-two batch buckets. Examples are nested
    dicts/lists/tuples of ndarrays WITHOUT a batch dim (one example each);
    they reach ``apply_fn`` as tensors on ``device`` (default: the params'
    device, else the card), and outputs are split back one numpy tree per
    request."""

    def __init__(self, apply_fn: Callable, params, config: Optional[ServeConfig] = None,
                 device=None):
        config = config or ServeConfig()
        self.config = config
        self.capacity = config.max_batch
        self._params = params
        self._apply = apply_fn
        if device is None:
            try:
                device = params_device(params)
            except ValueError:
                device = resolve_device(None)
        self.device = torch.device(device)

    @torch.no_grad()
    def run(self, examples: List) -> List:
        n = len(examples)
        # Pad the batch dim to the next power of two (a bounded set of
        # shapes) by repeating the last example; padded outputs are dropped.
        padded_n = 1
        while padded_n < n:
            padded_n *= 2
        batch = examples + [examples[-1]] * (padded_n - n)
        stacked = tree_map(lambda *xs: torch.from_numpy(np.stack(xs, axis=0)).to(self.device),
                           *batch)
        with telemetry.span("serve.apply_dispatch", batch=n, padded=padded_n):
            out = self._apply(self._params, stacked)
        out = tree_map(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t)
                       else np.asarray(t), out)
        return [tree_map(lambda a: a[i], out) for i in range(n)]
