"""Paged KV-cache serving (vLLM-style block tables).

Counterpart of ``autoawq_tpu/serve/paged.py``. K/V live in a shared pool of
fixed-size pages [nkv, total_pages, page_size, hd] per layer (int8 with
per-(head, page, line) f32 scales when ``kv_quant=True``); a request owns
``ceil(budget / page_size)`` pages, so short and long requests share one
pool. Scheduling mirrors ``serve/batching.BatchingEngine`` (FIFO admission,
per-slot retirement, one decode step for the pool). Specifics:

* Page 0 is the trash page: inactive slots' table rows point at it, so the
  pool decode step (which writes every slot's K/V somewhere) never touches
  a live request's pages.
* A request reserves its whole budget (prompt + max_new_tokens + 1) at
  admission: no page faults or preemption mid-flight, and a burst needs no
  allocation.
* Decode attention reads pages in place through the table with K7
  (``paged_attn="bespoke"``, the default on the card), or K9
  (``"stock"``, bf16 pools without a window), or gathers the table's pages
  into a slab (``"gather"``, the JAX package's default formulation);
  ``nn/modules._paged_decode``.
* Prefix caching (default on): full prompt pages are hash-chained
  (h_i = hash(h_{i-1}, page tokens)) and registered at admission; a
  repeated prefix reuses the cached pages (gathered into the prefill row,
  suffix-only prefill). Pages are refcounted; retired-but-cached pages are
  evicted LRU under admission pressure, two-phase (nothing is evicted
  unless the need can be met).
* Chunked admission (``prefill_chunk_size``, a multiple of the page size).
* Sliding-window models recycle pages wholly behind the window mid-flight.
* MLA models page the latent cache: one [compressed kv | rope head] row a
  token shared by every head (``c_pages`` [1, P, ps, dc + dr]), decoded by
  the absorbed formulation over the table's gathered rows
  (``nn/modules.mla_attention``). Prefill rows stay in the float dtype; an
  int8 pool (``kv_quant=True``) quantizes them on install with separate
  scales for the two parts (``c_page_s`` [1, P, ps, 2]) and dequantizes
  cached prefix pages on gather.

* A multimodal request (``prompt_embeds`` [S, H]) prefills whole from its
  embeds (no chunking); each page's chain hash also covers a digest of its
  embed rows, taken from one host copy at ``add_request``, so a repeated
  image shares pages and a different image behind the same placeholder ids
  does not. The suffix after shared pages prefills from its embed rows.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.utils.device import resolve_device
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.serve.batching import (Request, SamplingSlots,
                                              advance_one_chunk,
                                              decode_burst, prefill_chunk,
                                              prompt_rows)

ROUTES = ("bespoke", "stock", "gather")


def paged_decode_step(cfg: ModelConfig, params: Dict[str, Any],
                      tokens: torch.Tensor,
                      page_caches: List[Dict[str, torch.Tensor]],
                      table: torch.Tensor, pos: torch.Tensor,
                      method: str = "auto",
                      dtype: torch.dtype = torch.bfloat16,
                      paged_attn: str = "bespoke"
                      ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One decode token for every slot against the page pool: tokens
    [B, 1], table [B, PPS], pos [B] on the device; returns ([B, V] f32
    logits, page_caches written in place)."""
    cap = table.shape[1] * next(iter(page_caches[0].values())).shape[2]
    x = modules.embed(cfg, params, tokens, dtype, pos[:, None])
    cos, sin = modules.rope_tables(cfg, pos[:, None], seq_len=cap)
    for lp, pc in zip(params["layers"], page_caches):
        kv = {**pc, "page_table": table, "pos": pos}
        x, _ = modules.block(cfg, lp, x, cos, sin, None, kv_cache=kv,
                             method=method, paged_attn=paged_attn)
    logits = modules.logits_fn(cfg, params, x, method)
    return logits[:, 0, :], page_caches


def paged_decode_burst(cfg: ModelConfig, params: Dict[str, Any],
                       page_caches, tokens: torch.Tensor,
                       table: torch.Tensor, pos: torch.Tensor,
                       generator: torch.Generator, pres: torch.Tensor,
                       temp: torch.Tensor, topk: torch.Tensor,
                       topp: torch.Tensor, penalty: torch.Tensor, *, n: int,
                       method: str = "auto",
                       dtype: torch.dtype = torch.bfloat16,
                       paged_attn: str = "bespoke", tracking: bool = False,
                       sampling: bool = False, want_lp: bool = False,
                       want_top: int = 0):
    """``n`` paged pool steps with no host read (``batching.decode_burst``
    over :func:`paged_decode_step`). The table is fixed for the burst:
    every slot's pages were reserved at admission; window recycling and
    retirement replay on the host afterwards."""
    def step(tok, caches, p):
        return paged_decode_step(cfg, params, tok, caches, table, p, method,
                                 dtype, paged_attn)
    return decode_burst(step, page_caches, tokens, pos, generator, pres,
                        temp, topk, topp, penalty, n=n, tracking=tracking,
                        sampling=sampling, want_lp=want_lp, want_top=want_top)


def _page_digests(embeds: torch.Tensor, ps: int) -> List[bytes]:
    """SHA-1 of each full page's embed rows [ps, H], from one host copy of
    the request's [S, H] embeds (their raw bytes, whatever the dtype)."""
    import hashlib

    raw = embeds.detach().cpu().contiguous()
    raw = raw.view(torch.uint8).reshape(raw.shape[0], -1).numpy()
    return [hashlib.sha1(raw[i * ps:(i + 1) * ps].tobytes()).digest()
            for i in range(raw.shape[0] // ps)]


# pool key <-> contiguous-row key; the scale entries exist only in int8
# pools / rows; c_pages is the MLA latent pool
_PAGE_KEYS = (("k_pages", "k"), ("v_pages", "v"),
              ("k_page_s", "k_s"), ("v_page_s", "v_s"), ("c_pages", "c"))


def _install_pages(page_caches, row_caches, page_ids: torch.Tensor,
                   n_pages: int, start_page: int = 0, mla_dc: int = 0):
    """Copy row positions [start_page * ps, (start_page + n_pages) * ps) of
    a contiguous single-request prefill cache into pool pages ``page_ids``
    (K/V and, for int8 pools, their scales), in place. An int8 MLA pool
    quantizes the float latent rows here, its compressed-kv part (the
    first ``mla_dc`` = kv_lora_rank values) and rope part scaled
    apart."""
    for pc, row in zip(page_caches, row_caches):
        ps = next(iter(pc.values())).shape[2]
        lo, hi = start_page * ps, (start_page + n_pages) * ps
        for pk, rk in _PAGE_KEYS:
            if pk not in pc:
                continue
            dst = pc[pk]
            src = row[rk][0, :, lo:hi]  # [nkv, n * ps(, hd)]
            if pk == "c_pages" and "c_page_s" in pc:
                q, s2 = modules._latent_row(src[..., :mla_dc],
                                            src[..., mla_dc:], True)
                dst[:, page_ids] = q.reshape(1, n_pages, ps, -1)
                pc["c_page_s"][:, page_ids] = s2.reshape(1, n_pages, ps, 2)
                continue
            dst[:, page_ids] = src.reshape(
                dst.shape[0], n_pages, ps, *src.shape[2:]).to(dst.dtype)
    return page_caches


def _gather_pages(page_caches, row_caches, page_ids: torch.Tensor,
                  n_pages: int, mla_dc: int = 0):
    """Inverse of ``_install_pages``: pool pages into row positions
    [0, n_pages * ps), in place (the prefix-cache hit path); an int8 MLA
    pool's pages dequantize into the float row."""
    for pc, row in zip(page_caches, row_caches):
        ps = next(iter(pc.values())).shape[2]
        for pk, rk in _PAGE_KEYS:
            if pk not in pc:
                continue
            g = pc[pk][:, page_ids]  # [nkv, n, ps(, hd)]
            g = g.reshape(g.shape[0], n_pages * ps, *g.shape[3:])
            if pk == "c_pages" and "c_page_s" in pc:
                s2 = pc["c_page_s"][:, page_ids].reshape(1, n_pages * ps, 2)
                g = g.float()
                g = torch.cat([g[..., :mla_dc] * s2[..., :1],
                               g[..., mla_dc:] * s2[..., 1:]], dim=-1)
            row[rk][0, :, : n_pages * ps] = g.to(row[rk].dtype)
    return row_caches


class PagedBatchingEngine(SamplingSlots):
    """FIFO continuous batching over a shared KV page pool."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 max_batch: int = 8, page_size: int = 64,
                 total_pages: int = 512, pages_per_seq: int = 32,
                 eos_token_id: Optional[int] = None, method: str = "auto",
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 prefix_cache: bool = True,
                 prefill_chunk_size: Optional[int] = None,
                 return_logprobs: bool = False, top_logprobs: int = 0,
                 kv_quant: bool = False, device=None,
                 paged_attn: str = "bespoke"):
        modules.check_supported(cfg)
        if paged_attn not in ROUTES:
            raise ValueError(f"paged_attn {paged_attn!r} is not one of "
                             f"{ROUTES}")
        if prefill_chunk_size is not None \
                and prefill_chunk_size % page_size:
            # chunk boundaries land on page boundaries, so the scratch row
            # (a page multiple) never clips a chunk write
            raise ValueError(
                f"prefill_chunk_size ({prefill_chunk_size}) must be a "
                f"multiple of page_size ({page_size})")
        self.cfg, self.params = cfg, params
        self.max_batch, self.ps = max_batch, page_size
        self.pps = pages_per_seq
        self.eos, self.method, self.dtype = eos_token_id, method, dtype
        self.paged_attn = paged_attn
        self.device = resolve_device(device)
        gen._check_rope_capacity(cfg, pages_per_seq * page_size)
        self.kv_quant = kv_quant
        # int8 MLA pools quantize and dequantize at the pool's boundary,
        # splitting each latent row after its compressed-kv part
        self._mla_dc = cfg.kv_lora_rank if (cfg.is_mla and kv_quant) else 0
        shape = (cfg.num_key_value_heads, total_pages, page_size,
                 cfg.head_dim_)
        dev = self.device

        def pool():
            if cfg.is_mla:  # one latent row a token, shared by every head
                lshape = (1, total_pages, page_size,
                          cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                if not kv_quant:
                    return {"c_pages": torch.zeros(lshape, dtype=dtype,
                                                   device=dev)}
                return {"c_pages": torch.zeros(lshape, dtype=torch.int8,
                                               device=dev),
                        "c_page_s": torch.zeros(lshape[:3] + (2,),
                                                device=dev)}
            if kv_quant:  # int8 pages + per-(head, page, line) scales
                return {"k_pages": torch.zeros(shape, dtype=torch.int8,
                                               device=dev),
                        "v_pages": torch.zeros(shape, dtype=torch.int8,
                                               device=dev),
                        "k_page_s": torch.zeros(shape[:3], device=dev),
                        "v_page_s": torch.zeros(shape[:3], device=dev)}
            return {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
                    "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}
        self.pages = [pool() for _ in range(cfg.num_hidden_layers)]
        self.free: List[int] = list(range(total_pages - 1, 0, -1))  # 0=trash
        self.table = np.zeros((max_batch, pages_per_seq), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(max_batch)]
        # leading pages already recycled behind a sliding window
        self.win_dropped = np.zeros((max_batch,), np.int64)
        self.pos = np.zeros((max_batch,), np.int64)
        self.last_token = np.zeros((max_batch,), np.int64)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self.finished: List[Request] = []
        self.chunk = prefill_chunk_size
        self.inflight: Dict[int, Dict[str, Any]] = {}  # slot -> prefill st
        self.return_logprobs = return_logprobs or top_logprobs > 0
        self.top_logprobs = top_logprobs
        self._init_sampling(max_batch, cfg.vocab_size, seed)
        # prefix cache: chain hash -> page id, page id -> chain hash, chain
        # hash -> child hashes (eviction drops unreachable descendants)
        self.prefix_enabled = prefix_cache
        self.page_ref = np.zeros((total_pages,), np.int64)
        self.prefix_cache: Dict[int, int] = {}
        self.page_chain: Dict[int, int] = {}
        self.chain_next: Dict[int, set] = {}
        self.prefix_hits = 0
        self.prefix_pages_reused = 0

    # -------------------------------------------------------- scheduling
    def add_request(self, req_id: Any, prompt, max_new_tokens: int = 128,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    repetition_penalty: float = 1.0,
                    stop: Optional[List[List[int]]] = None,
                    prompt_embeds=None):
        prompt = np.asarray(prompt).reshape(-1)
        prompt_embeds = prompt_rows(prompt_embeds, len(prompt), self.device)
        budget = len(prompt) + max_new_tokens + 1
        if budget > self.pps * self.ps:
            raise ValueError(
                f"prompt+budget {budget} exceeds pages_per_seq*page_size "
                f"({self.pps * self.ps})")
        req = Request(req_id, prompt, max_new_tokens, temperature, top_k,
                      top_p, repetition_penalty, stop, prompt_embeds)
        req.page_digests = (None if prompt_embeds is None
                            else _page_digests(prompt_embeds, self.ps))
        self.queue.append(req)

    # ------------------------------------------------------ prefix cache
    @staticmethod
    def _page_chain_hashes(prompt: np.ndarray, ps: int, max_pages: int,
                           digests: Optional[List[bytes]] = None
                           ) -> List[int]:
        """Chain hashes of the first ``max_pages`` full pages; a multimodal
        prompt's keys add each page's embed digest (``_page_digests``):
        every LLaVA prompt carries the same image placeholder ids, so only
        bit-equal embeds share a page."""
        out, h = [], 0
        for i in range(max_pages):
            key: Any = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            if digests is not None:
                key = (key, digests[i])
            h = hash((h, key))
            out.append(h)
        return out

    def _drop_chain_entry(self, h: int) -> None:
        """Remove a cached chain entry and its descendants (unreachable
        once their parent is gone). Pages free at once at refcount 0;
        pinned pages free at their owner's retirement."""
        pid = self.prefix_cache.pop(h, None)
        for child in self.chain_next.pop(h, ()):
            self._drop_chain_entry(child)
        if pid is not None:
            del self.page_chain[pid]
            if self.page_ref[pid] == 0:
                self.free.append(pid)

    def _evict_until(self, need: int) -> bool:
        """Make ``need`` pages free by evicting unreferenced cached pages,
        LRU (insertion order). Two-phase: nothing is evicted unless the
        need can be met. Callers pin the pages they matched first."""
        if len(self.free) >= need:
            return True
        evictable = sum(
            1 for pid in self.page_chain if self.page_ref[pid] == 0)
        if len(self.free) + evictable < need:
            return False
        for h in list(self.prefix_cache):
            if len(self.free) >= need:
                break
            pid = self.prefix_cache.get(h)
            if pid is not None and self.page_ref[pid] == 0:
                self._drop_chain_entry(h)
        return len(self.free) >= need

    def _ids(self, pages: List[int]) -> torch.Tensor:
        return self._h2d(np.asarray(pages, np.int64))

    def _admit(self):
        for slot in range(self.max_batch):
            if (self.slots[slot] is not None or slot in self.inflight
                    or not self.queue):
                continue
            req = self.queue[0]
            budget = len(req.prompt) + req.max_new_tokens + 1
            need = -(-budget // self.ps)

            # prefix lookup: the longest chain of cached full prompt pages,
            # capped so at least one prompt token is left to prefill (its
            # logits seed generation) and the last prompt token never sits
            # in a shared (read-only) page
            shared: List[int] = []
            chain: List[int] = []
            if self.prefix_enabled:
                max_sharable = (len(req.prompt) - 1) // self.ps
                chain = self._page_chain_hashes(
                    req.prompt, self.ps, max_sharable, req.page_digests)
                for h in chain:
                    pid = self.prefix_cache.get(h)
                    if pid is None:
                        break
                    # a hit moves to the end: eviction walks insertion
                    # order, so this is LRU
                    self.prefix_cache[h] = self.prefix_cache.pop(h)
                    shared.append(pid)
            n_shared = len(shared)
            # pin matched pages first: eviction must never free a page
            # that is about to be shared
            for pid in shared:
                self.page_ref[pid] += 1
            if not self._evict_until(need - n_shared):
                for pid in shared:  # unpin; the head retries next step
                    self.page_ref[pid] -= 1
                return  # FIFO: wait for pages rather than starve the head
            self.queue.popleft()
            fresh = [self.free.pop() for _ in range(need - n_shared)]
            pages = shared + fresh
            for pid in fresh:
                self.page_ref[pid] += 1
            self.owned[slot] = pages
            # the table stays at the trash page until the slot activates:
            # the pool step writes every slot's K/V at table[slot, pos//ps],
            # and an inflight slot (pos 0) would write line 0 of pages[0],
            # which can be a shared prefix page
            self.table[slot] = 0
            if n_shared:
                self.prefix_hits += 1
                self.prefix_pages_reused += n_shared

            if self.chunk is not None and req.prompt_embeds is None:
                # an embeds prompt prefills whole, as in JAX; chunking
                # starts at the shared-prefix boundary (a page multiple,
                # not always a chunk multiple): the row reaches the last
                # chunk's end
                lo0 = n_shared * self.ps
                suffix_len = len(req.prompt) - lo0
                t_row = lo0 + max(-(-suffix_len // self.chunk) * self.chunk,
                                  self.ps)
                row = self._row(t_row)
                if n_shared:
                    row = _gather_pages(self.pages, row, self._ids(shared),
                                        n_shared, self._mla_dc)
                self.inflight[slot] = {
                    "req": req, "row": row, "done": lo0, "pages": pages,
                    "chain": chain, "n_shared": n_shared,
                }
                continue

            # whole-prompt admission: prefill the non-shared suffix against
            # a contiguous row whose prefix K/V is gathered from the pages
            n_prompt_pages = -(-len(req.prompt) // self.ps)
            row = self._row(n_prompt_pages * self.ps)
            if n_shared:
                row = _gather_pages(self.pages, row, self._ids(shared),
                                    n_shared, self._mla_dc)
                suffix = req.prompt[n_shared * self.ps:]
                real = len(suffix)
                # padded to a page multiple; the padded rows are dead
                # (decode overwrites them before they are unmasked)
                pad_to = -(-real // self.ps) * self.ps
                if pad_to > real:
                    suffix = np.pad(suffix, (0, pad_to - real))
                emb = None
                if req.prompt_embeds is not None:  # the suffix's rows
                    emb = torch.nn.functional.pad(
                        req.prompt_embeds[n_shared * self.ps:],
                        (0, 0, 0, pad_to - real))[None]
                logits, row = prefill_chunk(
                    self.cfg, self.params,
                    torch.as_tensor(suffix[None], dtype=torch.long,
                                    device=self.device),
                    row, n_shared * self.ps, self.method, self.dtype,
                    embeds=emb)
                logits = logits[:, real - 1]
            else:
                logits, row = gen.prefill(
                    self.cfg, self.params,
                    torch.as_tensor(req.prompt[None], dtype=torch.long,
                                    device=self.device),
                    row, self.method, self.dtype,
                    embeds=(None if req.prompt_embeds is None
                            else req.prompt_embeds[None]))
            self._finish_admission(slot, req, row, logits, pages, chain,
                                   n_shared)

    def _row(self, t_row: int):
        """A prefill row: int8 where the pool is, but an MLA row stays in
        the float dtype (its pool quantizes on install)."""
        return gen.init_kv_cache(self.cfg, 1, t_row, self.dtype, self.device,
                                 kv_quant=self.kv_quant
                                 and not self.cfg.is_mla)

    def _advance_prefill(self):
        """One chunk for every in-flight admission."""
        for slot, st in list(self.inflight.items()):
            tail = advance_one_chunk(self.cfg, self.params, st, self.chunk,
                                     self.method, self.dtype)
            if tail is not None:
                del self.inflight[slot]
                self._finish_admission(
                    slot, st["req"], st["row"], tail, st["pages"],
                    st["chain"], st["n_shared"])

    def _finish_admission(self, slot: int, req: Request, row, logits,
                          pages: List[int], chain: List[int],
                          n_shared: int):
        """Scatter the prefilled prompt pages into the pool, register the
        prefix chain and activate the slot (its table row points at real
        pages only from here)."""
        self.table[slot] = 0
        self.table[slot, : len(pages)] = pages
        n_prompt_pages = -(-len(req.prompt) // self.ps)
        if n_prompt_pages > n_shared:
            self.pages = _install_pages(
                self.pages, row, self._ids(pages[n_shared:n_prompt_pages]),
                n_prompt_pages - n_shared, start_page=n_shared,
                mla_dc=self._mla_dc)
        if self.prefix_enabled:
            prev_h = None
            for h, pid in zip(chain, pages):
                if h not in self.prefix_cache \
                        and pid not in self.page_chain:
                    self.prefix_cache[h] = pid
                    self.page_chain[pid] = h
                if prev_h is not None:
                    self.chain_next.setdefault(prev_h, set()).add(h)
                prev_h = h

        self._set_sampling(slot, req)
        tok = self._sample_slot(slot, logits[:1])
        self._note_token(slot, tok)
        self._record_logprobs_slot(slot, req, logits[:1], tok)
        req.output.append(tok)
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_token[slot] = tok
        self._retire_if_done(slot)

    def _release_pages(self, pages: List[int]) -> None:
        """Drop one reference per page; uncached pages at refcount 0 return
        to the free pool (cached ones stay for future prefix hits)."""
        for pid in reversed(pages):
            self.page_ref[pid] -= 1
            if self.page_ref[pid] == 0 and pid not in self.page_chain:
                self.free.append(pid)

    def _recycle_window_pages(self, slot: int) -> None:
        """Sliding-window models: pages wholly behind the window are never
        read again; return them to the pool mid-flight (a shared prefix
        page just loses this slot's reference)."""
        win = self.cfg.sliding_window
        first_needed = max(0, int(self.pos[slot]) - win) // self.ps
        dropped = self.win_dropped[slot]
        if first_needed <= dropped:
            return
        self._release_pages(self.owned[slot][dropped:first_needed])
        self.table[slot, dropped:first_needed] = 0
        self.win_dropped[slot] = first_needed

    def _free_slot(self, slot: int) -> None:
        self._release_pages(self.owned[slot][self.win_dropped[slot]:])
        self.owned[slot] = []
        self.win_dropped[slot] = 0
        self.table[slot] = 0  # trash page: decode writes go nowhere
        self.pos[slot] = 0
        self._clear_sampling(slot)

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out.update(
            free_pages=len(self.free),
            cached_pages=len(self.page_chain),
            prefix_hits=self.prefix_hits,
            prefix_pages_reused=self.prefix_pages_reused,
        )
        return out

    def _retire_if_done(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        # stop first, as in batching._retire_if_done
        if (req.stop and req.hit_stop()) \
                or (req.output and req.output[-1] == self.eos) \
                or len(req.output) >= req.max_new_tokens:
            req.done = True
            self.finished.append(req)
            self.slots[slot] = None
            self._free_slot(slot)

    def _advance(self, slot: int, tok: int) -> None:
        """A burst's host bookkeeping for one token (window recycling runs
        after the burst, as JAX's does)."""
        self.pos[slot] += 1
        self.last_token[slot] = tok
        self._retire_if_done(slot)

    # ------------------------------------------------------------- steps
    @torch.inference_mode()
    def step(self) -> List[Tuple[Any, int]]:
        """Admit, advance in-flight chunked prefills, then one decode token
        for every active slot."""
        self._admit()
        if self.inflight:
            self._advance_prefill()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        logits, self.pages = paged_decode_step(
            self.cfg, self.params, self._h2d(self.last_token[:, None]),
            self.pages, self._h2d(self.table), self._h2d(self.pos),
            self.method, self.dtype, self.paged_attn)
        toks_dev = self._sample_pool(logits)
        self._note_tokens_all(toks_dev)
        self._record_logprobs(logits, toks_dev, active)
        toks = toks_dev.cpu().numpy()
        emitted = []
        for slot in active:
            tok = int(toks[slot])
            req = self.slots[slot]
            req.output.append(tok)
            self.pos[slot] += 1
            if self.cfg.sliding_window and self.slots[slot] is not None:
                self._recycle_window_pages(slot)
            self.last_token[slot] = tok
            self._retire_if_done(slot)
            if not req._stopped:  # see BatchingEngine.step
                emitted.append((req.id, tok))
        return emitted

    @torch.inference_mode()
    def step_burst(self, n: int) -> List[Tuple[Any, int]]:
        """``n`` paged decode steps with no host read between them
        (:func:`paged_decode_burst`); the same streams as ``n`` single
        steps (see ``BatchingEngine.step_burst``). Window recycling runs
        once afterwards."""
        self._admit()
        if self.inflight or n <= 1:
            return self.step()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        cap = self.pps * self.ps
        n = min(n, min(cap - 1 - int(self.pos[s]) for s in active))
        if n <= 1:
            return self.step()
        table = self._h2d(self.table)

        def decode(caches, *a, **kw):
            return paged_decode_burst(
                self.cfg, self.params, caches, a[0], table, *a[1:],
                method=self.method, dtype=self.dtype,
                paged_attn=self.paged_attn, **kw)
        toks, lps, tops, self.pages = self._burst(self.pages, n, decode)
        emitted = self._replay_burst(active, toks, lps, tops)
        if self.cfg.sliding_window:
            for slot in active:
                if self.slots[slot] is not None:
                    self._recycle_window_pages(slot)
        return emitted
