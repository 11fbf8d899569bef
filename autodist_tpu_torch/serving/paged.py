"""Paged KV cache: block-granular decode memory + shared-prefix reuse (the
port of ``autodist_tpu/serving/paged.py``).

The dense ``runtime.LMEngine`` allocates one ``[max_batch, max_len, H, D]``
slab row per slot, so concurrency is capped at ``max_batch`` even when every
request is short. This module replaces the slab with a POOL of fixed-size
pages (``[num_pages, page_len, H, D]`` per layer) plus a host-side page
table, vLLM-style (PAPERS.md):

- a request owns ``ceil(frontier / page_len)`` pages, allocated LAZILY as
  its write frontier crosses page boundaries and freed the moment it
  completes — admission gates on RESERVABLE PAGES (``can_admit``), not free
  slots, lifting sustainable concurrency past ``max_batch`` for short
  workloads at the SAME HBM budget;
- requests sharing a system-prompt prefix (page-aligned, matched by token
  CONTENT) reference the same immutable prefilled pages instead of
  re-prefilling them; divergence is copy-on-write at page granularity —
  writes always land in a request's OWN pages (shared columns scatter to
  the scratch page), so a cached prefix can never be corrupted by a reader.

Bit-identity with the dense engine is by construction, resting on three
empirically pinned properties of the model's decode path (f32 softmax with
an additive -1e9 mask), held by the port's tests on the CPU and by
``chip_smoke.py`` on the card:

1. WIDTH invariance: decode/prefill over a gathered ``K * page_len``-wide
   cache (the sub-model trick: ``dataclasses.replace(cfg, max_len=K*P)`` +
   a sliced ``pos_embed``) is bit-identical to the full-``max_len`` run —
   finite garbage beyond the masked frontier contributes exactly 0.0.
2. SPLIT-prefill exactness: prefilling a shared prefix of ``j`` pages and
   then applying only the suffix with ``cache_index = pos_offset = j*P``
   reproduces the one-shot prefill bit for bit (the prefix-cache path).
3. Decode is NOT batch-size invariant, but IS row-content independent at a
   FIXED batch — so the paged engine decodes in groups of EXACTLY
   ``max_batch`` rows (dummy rows pad short groups), one dispatch per
   group, and each row's token stream matches its dense-slab twin.

The step shapes stay bounded by the same bucketing discipline as the dense
engine (``runtime.py``): decode steps are keyed by the group's PAGE bucket
``K`` (powers of two up to ``ceil(max_len/page_len)``), prefills by ``(K,
suffix_bucket)``. The pool is written in place: a decode step scatters each
row's frontier page back with one ``index_put_`` a layer, a prefill its own
pages; the gathered ``K * page_len`` context is a per-step copy.

Page REUSE without scrubbing (the dense engine's slot-reuse invariant,
restated for pages): a freed page returns to the pool with its stale K/V
intact. The next owner is safe because (a) every position a real query can
attend is either freshly written by that request's own prefill/decode or
belongs to a content-matched shared-prefix page, and (b) stale positions
beyond the frontier sit behind the additive -1e9 mask, which contributes an
exact 0.0 in the f32 softmax. ``tests/test_torch_serve_fleet.py`` pins this
by poisoning freed pages and asserting unchanged tokens.
"""

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.models import transformer_lm
from autodist_tpu_torch.models.common import lm_head_logits, make_keys, sample_logits
from autodist_tpu_torch.serving.batcher import (ServeConfig, ServeError, bucket_for,
                                                default_buckets, pad_prompt)
from autodist_tpu_torch.serving.runtime import params_device
from autodist_tpu_torch.telemetry import reqtrace as _reqtrace


def page_buckets(max_pages: int) -> Tuple[int, ...]:
    """Power-of-two page-count buckets up to ``max_pages`` (inclusive as the
    last bucket) — one decode program per bucket, like the prompt buckets."""
    out: List[int] = []
    b = 1
    while b < max_pages:
        out.append(b)
        b *= 2
    out.append(max_pages)
    return tuple(out)


class PageAllocator:
    """Host-side free-list + refcount + reservation ledger over the page
    pool. Page 0 is SCRATCH — never allocated; dummy decode rows and
    discarded scatter columns (shared-prefix pages, pad columns) all target
    it, so its content is garbage by design and always masked.

    Reservations make lazy frontier-crossing draws infallible: admission
    reserves a request's whole-lifetime page budget up front, so an admitted
    request can always draw its next page mid-decode — overload is decided
    once, at the admission edge, never as mid-stream corruption."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("page pool needs >= 2 pages (one is scratch)")
        self.usable = num_pages - 1
        self._free = list(range(num_pages - 1, 0, -1))   # pop() -> 1, 2, ...
        self._ref: Dict[int, int] = {}
        self._reserved = 0

    def free_count(self) -> int:
        return len(self._free)

    def available(self) -> int:
        return len(self._free) - self._reserved

    def can_reserve(self, n: int) -> bool:
        return self.available() >= n

    def reserve(self, n: int):
        if not self.can_reserve(n):
            raise ServeError(f"cannot reserve {n} KV pages "
                             f"({self.available()} available)")
        self._reserved += n

    def unreserve(self, n: int):
        self._reserved -= n
        assert self._reserved >= 0, "page reservation ledger went negative"

    def alloc(self) -> int:
        """Draw one page against an existing reservation (ref = 1)."""
        assert self._reserved > 0, "page alloc without a reservation"
        page = self._free.pop()
        self._ref[page] = 1
        self._reserved -= 1
        return page

    def retain(self, page: int):
        self._ref[page] += 1

    def release(self, page: int):
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._free.append(page)


class PrefixCache:
    """LRU map from page-aligned prompt-prefix BYTES to the immutable page
    chain holding its prefilled K/V. The cache owns one reference per page
    (taken by the publisher); eviction releases them — a page still shared
    with a live request survives until that request completes."""

    def __init__(self):
        self._d: "OrderedDict[bytes, List[int]]" = OrderedDict()

    def __len__(self):
        return len(self._d)

    def __contains__(self, key: bytes):
        return key in self._d

    def lookup(self, key: bytes) -> Optional[List[int]]:
        entry = self._d.get(key)
        if entry is not None:
            self._d.move_to_end(key)
        return entry

    def put(self, key: bytes, pages: List[int]):
        self._d[key] = list(pages)
        self._d.move_to_end(key)

    def pop_lru(self) -> Optional[List[int]]:
        if not self._d:
            return None
        _, pages = self._d.popitem(last=False)
        return pages


class PagedLMEngine:
    """Drop-in replacement for ``runtime.LMEngine`` with paged KV memory.

    Same engine interface the batcher drives (``capacity`` / ``admit`` /
    ``step`` / ``free`` / ``make_keys``), plus ``can_admit(prompt_len,
    max_new)`` — the page-based admission gate the batcher consults before
    assigning a slot. ``capacity`` equals USABLE PAGES (every active request
    holds at least one page), so the slot table itself never caps
    concurrency; pages do.
    """

    def __init__(self, model, params, config: Optional[ServeConfig] = None):
        config = config or ServeConfig(page_len=16)
        if config.page_len < 1:
            raise ValueError("PagedLMEngine needs page_len >= 1 "
                             "(0 selects the dense LMEngine)")
        self.model = model
        self.config = config
        self._params = params
        self.device = params_device(params)
        cfg = model.config
        self.max_len = cfg.max_len
        self.page_len = P = min(config.page_len, cfg.max_len)
        self.max_pages = (cfg.max_len + P - 1) // P        # pages per request
        # Default pool at memory PARITY with the dense slab (max_batch rows
        # of max_len tokens) plus the scratch page — concurrency is compared
        # at equal KV bytes.
        num_pages = config.kv_pages or (config.max_batch * self.max_pages + 1)
        self._alloc = PageAllocator(num_pages)
        self.group = config.max_batch      # decode dispatch width (fixed B)
        self.capacity = self._alloc.usable
        self.buckets = tuple(b for b in (config.buckets or default_buckets(cfg.max_len))
                             if b <= cfg.max_len)
        if not self.buckets:
            raise ValueError(f"no pad bucket fits max_len {cfg.max_len}")
        self._page_buckets = page_buckets(self.max_pages)
        self._sampling = (float(config.temperature), int(config.top_k), float(config.top_p))
        self._prefix = PrefixCache() if config.prefix_cache else None
        B = self.capacity
        self._pos = np.zeros(B, np.int64)        # per-slot write frontier
        self._active = np.zeros(B, bool)
        self._last = np.zeros(B, np.int64)
        self._pages: List[List[int]] = [[] for _ in range(B)]
        self._reserved_left = np.zeros(B, np.int64)
        self._pending: List[Tuple[int, int, int]] = []   # can_admit -> admit
        self._decode_sigs: set = set()
        self._prefill_sigs: set = set()
        self._submodels: Dict[int, object] = {}
        self._sub_params: Dict[int, dict] = {}
        reg = telemetry.registry()
        self._m_used = reg.gauge("serve.kv.pages_used")
        self._m_free = reg.gauge("serve.kv.pages_free")
        self._m_hits = reg.counter("serve.kv.prefix_hits")
        self._m_miss = reg.counter("serve.kv.prefix_misses")
        # The pool: [num_pages, P, H, hd] per layer for keys and values, in
        # the compute dtype, zeros (every position a real query attends is
        # written first).
        hd = cfg.d_model // cfg.n_heads
        self._pool = {f"block_{i}.attn.{name}": torch.zeros(
            (num_pages, P, cfg.n_heads, hd), dtype=cfg.dtype, device=self.device)
            for i in range(cfg.n_layers) for name in ("cached_key", "cached_value")}
        # Census claim on the page pool: its fixed bytes (the pool is
        # preallocated and written in place, so the footprint never moves).
        try:
            from autodist_tpu_torch.telemetry import memplane
            memplane.tag("kv_pages", self.kv_bytes(), key=f"pool.{id(self)}")
        except Exception:  # noqa: BLE001 — census is best-effort
            pass
        self._set_gauges()

    # ---------------------------------------------------------- sub-models

    def _submodel(self, width: int):
        """The model re-instantiated at ``max_len=width`` with its params —
        the WIDTH invariance trick: a gathered K-page context runs through a
        ``K*P``-wide twin whose ``pos_embed`` is sliced (or zero-padded past
        max_len; such positions are only ever pad junk, masked and
        overwritten before any real query attends them). The twin is built on
        the meta device (one instance per engine and width: ``functional_call``
        swaps params into the module it applies, so engines in different
        threads must not share one); its params dict shares every tensor but
        ``pos_embed``."""
        m = self._submodels.get(width)
        if m is None:
            m = self._submodels[width] = type(self.model)(
                dataclasses.replace(self.model.config, max_len=width))
            pe = self._params["pos_embed"]
            if width <= pe.shape[0]:
                pe = pe[:width]
            else:
                pe = torch.cat([pe, pe.new_zeros((width - pe.shape[0], pe.shape[1]))], 0)
            self._sub_params[width] = {**self._params, "pos_embed": pe}
        return m, self._sub_params[width]

    def _gather(self, table: torch.Tensor, width: int, idx_fill: int) -> dict:
        """Pool pages -> a dense ``[rows, width, H, hd]`` context per table
        row (a copy), plus each block's ``cache_index`` set to ``idx_fill``
        (the suffix write offset for prefill; unused by vector decode)."""
        out = {}
        for key, leaf in self._pool.items():
            rows = leaf[table]                              # [rows, K, P, H, hd]
            out[key] = rows.reshape(rows.shape[0], width, *leaf.shape[2:])
        for i in range(self.model.config.n_layers):
            out[f"block_{i}.attn.cache_index"] = torch.tensor(idx_fill, dtype=torch.int32)
        return out

    def _sample(self, logits: torch.Tensor, seeds) -> torch.Tensor:
        """Per-row keys, exactly the dense engine's sampling path."""
        temp, top_k, top_p = self._sampling
        if temp == 0.0:
            return sample_logits(logits)
        key = torch.as_tensor(np.asarray(seeds, np.int64)).to(logits.device)
        return sample_logits(logits, key, temp, top_k, top_p)

    def _decode(self, K: int, table: np.ndarray, toks: np.ndarray, pos: np.ndarray,
                keys: np.ndarray) -> np.ndarray:
        """One decode step of a group over a gathered ``K``-page context;
        each row's frontier page is scattered back to the pool (dummy rows
        target the scratch page 0, where duplicate garbage writes are
        harmless)."""
        self._decode_sigs.add(K)
        P, L = self.page_len, K * self.page_len
        smodel, sparams = self._submodel(L)
        dev = self.device
        table_t = torch.from_numpy(table).to(dev)
        pos_t = torch.from_numpy(pos).to(dev)
        gathered = self._gather(table_t, L, 0)
        logits = transformer_lm.apply(smodel, sparams, torch.from_numpy(toks).to(dev)[:, None],
                                      pos_offset=pos_t, decode=True, cache=gathered)
        nxt = self._sample(logits[:, 0], keys)
        rows = torch.arange(table.shape[0], device=dev)
        pidx = pos_t // P                                          # [B]
        tgt = table_t[rows, pidx]
        for key, leaf in self._pool.items():
            new = gathered[key].reshape(table.shape[0], K, P, *leaf.shape[2:])
            leaf.index_put_((tgt,), new[rows, pidx])
        return nxt.cpu().numpy().astype(np.int32)

    def _prefill(self, K: int, bs: int, src: np.ndarray, tgt: np.ndarray, suffix: np.ndarray,
                 s_len: int, j_tok: int, key) -> int:
        """Unified (cold + prefix-hit) prefill: gather ``K`` pages (shared
        chain + fresh own pages + scratch pads) to a dense context, apply
        ONLY the suffix chunk at ``cache_index = pos_offset = j*P`` (the
        split-prefill exactness property), project the last real position,
        scatter own columns back (shared/pad columns dump to scratch)."""
        self._prefill_sigs.add((K, bs))
        P, L = self.page_len, K * self.page_len
        smodel, sparams = self._submodel(L)
        dev = self.device
        gathered = self._gather(torch.from_numpy(src).to(dev)[None], L, j_tok)
        hidden = transformer_lm.apply(smodel, sparams, torch.from_numpy(suffix).to(dev).long(),
                                      pos_offset=j_tok, decode=True, return_hidden=True,
                                      cache=gathered)
        lg = lm_head_logits(hidden[:, s_len - 1], sparams, tied=self.model.config.tied_output)
        first = int(self._sample(lg, None if key is None else [key])[0])
        tgt_t = torch.from_numpy(tgt).to(dev)
        for name, leaf in self._pool.items():
            leaf.index_put_((tgt_t,), gathered[name].reshape(K, P, *leaf.shape[2:]))
        return first

    @staticmethod
    def _k_pow2(needed: int) -> int:
        """Prefill gather-width bucket: smallest power of two >= needed.
        Unlike decode, prefill width may exceed ``max_pages`` (suffix
        BUCKET padding can reach past the true frontier); the extra
        columns gather/scatter scratch, so rounding up is cheap."""
        k = 1
        while k < needed:
            k *= 2
        return k

    # --------------------------------------------------------- page ledger

    def _pages_total(self, plen: int, max_new: int) -> int:
        """Whole-lifetime page budget: the last position ever WRITTEN is
        ``plen + max_new - 2`` (prefill writes [0, plen); the decode steps
        producing tokens 2..max_new write plen..plen+max_new-2)."""
        assert max_new >= 1
        return (plen + max_new - 2) // self.page_len + 1

    def _evict_for(self, n: int):
        """LRU-drop prefix-cache entries until ``n`` pages are reservable
        (or the cache is empty) — cached prefixes are a perf optimization
        and must never out-prioritize admitting a live request."""
        if self._prefix is None:
            return
        while len(self._prefix) and not self._alloc.can_reserve(n):
            for page in self._prefix.pop_lru() or []:
                self._alloc.release(page)

    def can_admit(self, prompt_len: int, max_new_tokens: int,
                  rid=None) -> bool:
        """The batcher's admission gate: True RESERVES the request's whole
        page budget (consumed by the matching ``admit``, FIFO); False = not
        yet (the batcher holds the request back); a request that can NEVER
        fit raises ``ServeError`` (rejected, not head-of-line-blocked). The
        budget ignores possible prefix sharing — conservative, so a lazy
        draw can never fail; ``admit`` returns the savings. ``rid`` is the
        request's trace key; when the gate holds the request back, an
        ``admit_wait`` mark records the page shortfall against it.

        Under device memory pressure (the memory plane's ``mem.pressure``
        at/above its threshold) the gate demands ``total`` plus a holdback
        (:func:`~autodist_tpu_torch.telemetry.memplane.kv_admission_holdback`)
        before admitting — NEW requests shed first while in-flight
        reservations keep their whole budget, so pressure degrades
        admission throughput instead of corrupting mid-decode draws."""
        total = self._pages_total(prompt_len, max_new_tokens)
        if total > self._alloc.usable:
            raise ServeError(
                f"request needs {total} KV pages but the pool owns only "
                f"{self._alloc.usable} (page_len={self.page_len})")
        holdback = 0
        try:
            from autodist_tpu_torch.telemetry import memplane
            holdback = memplane.kv_admission_holdback(self._alloc.usable)
        except Exception:  # noqa: BLE001 — pressure probe must not gate
            holdback = 0
        if not self._alloc.can_reserve(total + holdback):
            self._evict_for(total + holdback)
        if not self._alloc.can_reserve(total + holdback):
            if rid is not None:
                _reqtrace.mark(rid, "admit_wait", pages_needed=total,
                               pages_free=self._alloc.free_count(),
                               holdback=holdback)
            return False
        self._alloc.reserve(total)
        self._pending.append((prompt_len, max_new_tokens, total))
        return True

    def _take_reservation(self, plen: int,
                          max_new_tokens: Optional[int]) -> Tuple[int, int]:
        """(budget, max_new) for this admit: the head of the can_admit FIFO
        (the batcher admits in gate order), or a fresh worst-case
        reservation for direct callers that skipped the gate."""
        if self._pending:
            rplen, rmax_new, total = self._pending.pop(0)
            assert rplen == plen, "admit order diverged from can_admit order"
            return total, rmax_new
        max_new = max(1, max_new_tokens if max_new_tokens is not None
                      else self.max_len - plen)
        total = self._pages_total(plen, max_new)
        if not self._alloc.can_reserve(total):
            self._evict_for(total)
        self._alloc.reserve(total)       # raises ServeError when impossible
        return total, max_new

    def _set_gauges(self):
        free = self._alloc.free_count()
        self._m_used.set(self._alloc.usable - free)
        self._m_free.set(free)

    # ------------------------------------------------------ engine interface

    def make_keys(self, seed: int, n: int) -> Optional[np.ndarray]:
        """Identical key schedule to the dense engine (and to
        :func:`transformer_lm.generate`); None for greedy."""
        if self._sampling[0] == 0.0:
            return None
        return make_keys(seed, n)

    @torch.no_grad()
    def admit(self, slot: int, prompt: np.ndarray, key: Optional[int],
              max_new_tokens: Optional[int] = None) -> int:
        """Prefill ``prompt`` into ``slot``'s page chain; returns the first
        sampled token. Shared-prefix pages (matched by token content at
        page granularity) are referenced, not recomputed; only the suffix
        runs. ``max_new_tokens`` is only needed when ``can_admit`` was not
        called first (direct callers) — the batcher's gate already carries
        the page budget through the reservation FIFO."""
        P = self.page_len
        plen = int(prompt.size)
        total, _ = self._take_reservation(plen, max_new_tokens)
        # Longest content-matched page-aligned prefix, capped at
        # (plen-1)//P pages so the suffix keeps >= 1 token (the first
        # sampled token must come from a real suffix hidden state).
        j, shared = 0, []
        if self._prefix is not None:
            for m in range((plen - 1) // P, 0, -1):
                entry = self._prefix.lookup(prompt[:m * P].tobytes())
                if entry is not None:
                    j, shared = m, entry
                    break
            (self._m_hits if j else self._m_miss).inc()
        now = (plen - 1) // P + 1 - j          # pages covering the prompt
        for page in shared:
            self._alloc.retain(page)
        self._alloc.unreserve(j)               # the conservative gate's
        own = [self._alloc.alloc() for _ in range(now)]   # prefix savings
        s_len = plen - j * P                   # >= 1 by the j cap
        bs = bucket_for(s_len, self.buckets)
        K = self._k_pow2(j + (bs + P - 1) // P)
        src = np.zeros(K, np.int64)
        tgt = np.zeros(K, np.int64)            # shared/pad columns -> scratch
        src[:j] = shared
        src[j:j + now] = own
        tgt[j:j + now] = own
        suffix = pad_prompt(prompt[j * P:], bs)
        first = self._prefill(K, bs, src, tgt, suffix, s_len, j * P, key)
        self._pages[slot] = list(shared) + own
        self._reserved_left[slot] = total - j - now
        self._pos[slot] = plen
        self._active[slot] = True
        self._last[slot] = first
        # Publish this prompt's longest whole-page prefix (cold AND hit
        # admits — a hit may extend a shorter cached chain). Published
        # pages are never written again: the owner's decode frontier
        # starts at page >= (plen-1)//P + ... >= m_pub, and later readers
        # scatter their shared columns to scratch.
        if self._prefix is not None:
            m_pub = (plen - 1) // P
            if m_pub >= 1:
                kb = prompt[:m_pub * P].tobytes()
                if kb not in self._prefix:
                    chain = self._pages[slot][:m_pub]
                    for page in chain:
                        self._alloc.retain(page)
                    self._prefix.put(kb, chain)
        self._set_gauges()
        return first

    @torch.no_grad()
    def step(self, keys: Optional[np.ndarray] = None) -> np.ndarray:
        """One decode step for every ACTIVE slot, dispatched in groups of
        exactly ``self.group`` rows (short groups padded with dummy rows at
        page 0 / position 0 — decode is row-content independent at fixed
        batch, so padding never changes results); returns ``[capacity]``
        sampled tokens indexed by slot."""
        P = self.page_len
        out = np.zeros(self.capacity, np.int32)
        active = np.nonzero(self._active)[0]
        if active.size == 0:
            return out
        if keys is None:
            keys = np.zeros(self.capacity, np.int64)
        # Lazy frontier-crossing draws — infallible (reserved at admission).
        for s in active:
            need = int(self._pos[s]) // P + 1
            while len(self._pages[s]) < need:
                assert self._reserved_left[s] > 0, "page budget underflow"
                self._pages[s].append(self._alloc.alloc())
                self._reserved_left[s] -= 1
        B = self.group
        for g0 in range(0, active.size, B):
            slots = active[g0:g0 + B]
            kneed = max(len(self._pages[s]) for s in slots)
            K = bucket_for(kneed, self._page_buckets)
            table = np.zeros((B, K), np.int64)
            toks = np.zeros(B, np.int64)
            pos = np.zeros(B, np.int64)
            gkeys = np.zeros(B, np.int64)
            for i, s in enumerate(slots):
                chain = self._pages[s]
                table[i, :len(chain)] = chain
                toks[i] = self._last[s]
                pos[i] = self._pos[s]
                gkeys[i] = keys[s]
            nxt = self._decode(K, table, toks, pos, gkeys)
            for i, s in enumerate(slots):
                out[s] = nxt[i]
        self._pos = np.where(self._active, self._pos + 1, 0)
        self._last = np.where(self._active, out, 0).astype(np.int64)
        self._set_gauges()
        return out

    def free(self, slot: int):
        """Release the slot's page chain (shared pages decrement their
        refcount; a page returns to the pool at ref 0 with its stale K/V
        INTACT — the page-reuse staleness invariant in the module
        docstring) and unreserve any unfulfilled lazy budget (early EOS)."""
        for page in self._pages[slot]:
            self._alloc.release(page)
        self._pages[slot] = []
        if self._reserved_left[slot]:
            self._alloc.unreserve(int(self._reserved_left[slot]))
            self._reserved_left[slot] = 0
        self._active[slot] = False
        self._pos[slot] = 0
        self._last[slot] = 0
        self._set_gauges()

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    def kv_bytes(self) -> int:
        """Bytes of the page pool (scratch page included)."""
        return sum(v.numel() * v.element_size() for v in self._pool.values())

    def pool_snapshot(self) -> dict:
        """Wire-encodable pool view for status/consoles."""
        free = self._alloc.free_count()
        return {"page_len": self.page_len,
                "pages_total": self._alloc.usable,
                "pages_used": self._alloc.usable - free,
                "pages_free": free,
                "prefix_entries": len(self._prefix or ())}

    def compiled_programs(self) -> Tuple[int, int]:
        """(prefill signatures, all signatures) run so far — bounded by the
        (K, bucket) keying; tests pin it."""
        return (len(self._prefill_sigs),
                len(self._prefill_sigs) + len(self._decode_sigs))
