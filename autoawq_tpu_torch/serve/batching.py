"""Continuous batching: slot-based serving with per-request admission.

Counterpart of ``autoawq_tpu/serve/batching.py``. A fixed pool of
``max_batch`` KV slots ([B, nkv, T, hd] caches, each slot its own row and
write offset); requests are admitted into free slots as they arrive and
retired at their own EOS, stop sequence or budget, with one decode step for
the whole pool per iteration.

* A [B] position tensor drives per-slot cache writes through index tensors
  (``nn/modules._cache_write``) and a per-slot causal mask; inactive slots
  decode garbage that the host discards.
* Admission prefills one request into a scratch [1, ...] cache and copies
  that row into the slot; ``prefill_chunk_size`` instead advances a long
  prompt one chunk per engine step (chunked prefill). A multimodal
  request (``prompt_embeds``, the vision features spliced into its prompt)
  prefills whole from its embeds; decoding continues on token ids.
* Sampling state (temperature, top-k, top-p, repetition penalty) is per
  slot; the penalty's token presence [B, V] lives on the device. Sampling
  draws from a ``torch.Generator`` seeded from ``seed`` (Gumbel-max over the
  warped logits); its numbers differ from JAX's PRNG, so sampled streams
  differ from the JAX package's while greedy ones and the warped logits
  agree.
* A burst (:meth:`BatchingEngine.step_burst`) runs n decode+sample steps as
  a Python loop with tokens, positions and presence kept on the device and
  no host read inside, the counterpart of JAX's ``lax.scan``; emission and
  retirement replay on the host afterwards, so streams equal n single steps.

Engines run on the card unless the caller passes ``device="cpu"``; they are
not thread-safe (``serve/server.py`` drives one from a single thread).
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


def batched_decode_step(cfg: ModelConfig, params: Dict[str, Any],
                        tokens: torch.Tensor,
                        caches: List[Dict[str, torch.Tensor]],
                        pos: torch.Tensor, method: str = "auto",
                        dtype: torch.dtype = torch.bfloat16
                        ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One decode token for every slot: tokens [B, 1], pos [B] (per-slot
    lengths, on the device); returns ([B, V] f32 logits, caches)."""
    max_t = gen._cache_len(caches)
    x = modules.embed(cfg, params, tokens, dtype, pos[:, None])
    ki = torch.arange(max_t, device=pos.device)[None, :]
    ok = ki <= pos[:, None]
    if cfg.sliding_window:
        ok = ok & (ki > pos[:, None] - cfg.sliding_window)
    mask = torch.where(ok, 0.0, -1e30).float()[:, None, None, :]
    if cfg.pos_embed == "alibi":  # each slot's query sits at its own pos
        mask = mask + modules.alibi_slot_bias(cfg, pos, max_t)
    cos, sin = modules.rope_tables(cfg, pos[:, None], seq_len=max_t)
    for lp, cache in zip(params["layers"], caches):
        x, _ = modules.block(cfg, lp, x, cos, sin, mask,
                             kv_cache={**cache, "pos": pos}, method=method)
    logits = modules.logits_fn(cfg, params, x, method)
    return logits[:, 0, :], caches


def prefill_chunk(cfg: ModelConfig, params: Dict[str, Any],
                  tokens: torch.Tensor,
                  row_caches: List[Dict[str, torch.Tensor]], pos0: int,
                  method: str = "auto", dtype: torch.dtype = torch.bfloat16,
                  embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """One prompt chunk tokens [1, C] at offset ``pos0`` against a
    single-request cache; returns the chunk's [1, C, V] logits (the caller
    reads the last real position; padded tail positions write cache rows
    that decode overwrites before they are ever unmasked). ``embeds``
    [1, C, H] replaces the token embedding lookup (the paged engine's
    suffix of a multimodal prompt after its shared pages)."""
    c = tokens.shape[1]
    max_t = gen._cache_len(row_caches)
    dev = tokens.device
    positions = pos0 + torch.arange(c, device=dev)[None, :]
    x = (embeds.to(dtype) if embeds is not None
         else modules.embed(cfg, params, tokens, dtype, positions))
    ki = torch.arange(max_t, device=dev)[None, :]
    ok = ki <= positions[0][:, None]  # [C, T]
    if cfg.sliding_window:
        ok = ok & (ki > positions[0][:, None] - cfg.sliding_window)
    mask = torch.where(ok, 0.0, -1e30).float()[None, None]
    if cfg.pos_embed == "alibi":
        mask = mask + modules.alibi_bias(cfg,
                                         positions[0], ki[0])
    cos, sin = modules.rope_tables(cfg, positions, seq_len=max_t)
    for lp, cache in zip(params["layers"], row_caches):
        x, _ = modules.block(cfg, lp, x, cos, sin, mask,
                             kv_cache={**cache, "pos": pos0}, method=method)
    return modules.logits_fn(cfg, params, x, method), row_caches


def advance_one_chunk(cfg, params, st, chunk_size: int, method, dtype):
    """Advance one in-flight chunked admission ({"req", "row", "done"}) by
    one chunk, padded to ``chunk_size``; returns the tail [1, V] logits once
    the prompt is complete, else None. Shared by both engines."""
    req = st["req"]
    lo = st["done"]
    chunk = req.prompt[lo: lo + chunk_size]
    real = len(chunk)
    if real < chunk_size:
        chunk = np.pad(chunk, (0, chunk_size - real))
    dev = next(iter(st["row"][0].values())).device
    logits, st["row"] = prefill_chunk(
        cfg, params, torch.as_tensor(chunk[None], dtype=torch.long,
                                     device=dev),
        st["row"], lo, method, dtype)
    st["done"] += real
    if st["done"] >= len(req.prompt):
        return logits[:, real - 1]
    return None


def prompt_rows(prompt_embeds, n: int, device) -> Optional[torch.Tensor]:
    """A request's ``prompt_embeds`` as [S, H] on ``device`` ([1, S, H] is
    squeezed); ValueError unless S is the prompt's length ``n``."""
    if prompt_embeds is None:
        return None
    e = torch.as_tensor(prompt_embeds, device=device)
    if e.dim() == 3:
        e = e[0]
    if e.shape[0] != n:
        raise ValueError("prompt_embeds length != prompt length")
    return e


def _install_slot(caches, row_caches, slot: int):
    """Copy a single-request prefill cache row into pool slot ``slot``, in
    place."""
    for pool, row in zip(caches, row_caches):
        for key in pool:
            pool[key][slot] = row[key][0]
    return caches


def _token_logprobs(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log p(tok) per row of [B, V] logits (the unwarped model
    distribution, what OpenAI's logprobs field reports)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return lp.gather(-1, toks.long()[:, None])[:, 0]


def _top_n_logprobs(logits: torch.Tensor, n: int):
    """Top-n (logprob, token id) per row of [B, V] unwarped logits."""
    top = torch.topk(torch.log_softmax(logits.float(), dim=-1), n, dim=-1)
    return top.values, top.indices


def warp_batched(logits: torch.Tensor, temp: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot HF warper chain (temperature -> top_k -> top_p) with per-row
    parameters: temp [B] f32, top_k [B] (V = off), top_p [B] f32 (1.0 =
    off). Both cuts are value thresholds against the row's descending
    logits: top-k's the k-th largest, top-p's the smallest logit of the
    shortest prefix whose mass reaches p (ties at the edge survive). Returns
    the warped logits, -inf where cut."""
    v = logits.shape[-1]
    scaled = logits / temp.clamp_min(1e-6)[:, None]
    sv = torch.sort(scaled, dim=-1, descending=True).values
    thr_k = sv.gather(-1, (top_k.long() - 1).clamp(0, v - 1)[:, None])
    probs = torch.softmax(sv, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs  # exclusive cumsum
    n_keep = (before < top_p[:, None]).sum(-1)  # >= 1 always
    thr_p = sv.gather(-1, (n_keep - 1).clamp(0, v - 1)[:, None])
    thr = torch.maximum(thr_k, thr_p)
    return torch.where(scaled < thr, float("-inf"), scaled)


def _presence_note(presence: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Mark one decode step's tokens ([B]) in the [B, V] presence, in
    place."""
    rows = torch.arange(presence.shape[0], device=presence.device)
    presence[rows, toks.long()] = True
    return presence


def _penalize_batched(logits: torch.Tensor, penalty: torch.Tensor,
                      presence: torch.Tensor) -> torch.Tensor:
    """Per-slot HF RepetitionPenaltyLogitsProcessor: for tokens already in
    the slot's prompt or output, divide positive logits by the penalty and
    multiply negative ones (before the warpers, as HF orders them)."""
    pen = torch.where(logits > 0, logits / penalty[:, None],
                      logits * penalty[:, None])
    return torch.where(presence & (penalty[:, None] != 1.0), pen, logits)


def sample_batched(logits: torch.Tensor, temp: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """Per-slot token: argmax where temp <= 0, else a Gumbel-max draw from
    the warped logits (``warp_batched``). Draws for every row, so the
    generator advances the same way whichever slots sample."""
    greedy = torch.argmax(logits, dim=-1)
    masked = warp_batched(logits, temp, top_k, top_p)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    sampled = torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temp <= 0.0, greedy, sampled)


def decode_burst(step, caches, tokens: torch.Tensor, pos: torch.Tensor,
                 generator: torch.Generator, pres: torch.Tensor,
                 temp: torch.Tensor, topk: torch.Tensor, topp: torch.Tensor,
                 penalty: torch.Tensor, *, n: int, tracking: bool = False,
                 sampling: bool = False, want_lp: bool = False,
                 want_top: int = 0):
    """``n`` pool decode+sample steps with everything on the device and no
    host read (JAX's ``lax.scan`` of ``batched_decode_burst`` /
    ``paged_decode_burst``): ``step(tokens [B, 1], caches, pos)`` is one
    decode step returning ([B, V] logits, caches). The penalty presence,
    the warpers and the generator's draws are those of n successive single
    steps. Returns (toks [B, n], lps [B, n] | None, (top values, ids)
    [B, n, want_top] | None, caches, presence)."""
    toks, lps, top_v, top_i = [], [], [], []
    tok, p = tokens, pos
    for _ in range(n):
        logits, caches = step(tok[:, None], caches, p)
        lp_in = logits
        if tracking:
            logits = _penalize_batched(logits, penalty, pres)
        if sampling:
            nxt = sample_batched(logits, temp, topk, topp, generator)
        else:
            nxt = torch.argmax(logits, dim=-1)
        if tracking:
            pres = _presence_note(pres, nxt)
        toks.append(nxt)
        if want_lp:
            lps.append(_token_logprobs(lp_in, nxt))
        if want_top:
            v, i = _top_n_logprobs(lp_in, want_top)
            top_v.append(v)
            top_i.append(i)
        tok, p = nxt, p + 1
    tops = ((torch.stack(top_v, 1), torch.stack(top_i, 1)) if want_top
            else None)
    return (torch.stack(toks, 1), torch.stack(lps, 1) if want_lp else None,
            tops, caches, pres)


def batched_decode_burst(cfg: ModelConfig, params: Dict[str, Any], caches,
                         tokens: torch.Tensor, pos: torch.Tensor,
                         generator: torch.Generator, pres: torch.Tensor,
                         temp: torch.Tensor, topk: torch.Tensor,
                         topp: torch.Tensor, penalty: torch.Tensor, *,
                         n: int, method: str = "auto",
                         dtype: torch.dtype = torch.bfloat16,
                         tracking: bool = False, sampling: bool = False,
                         want_lp: bool = False, want_top: int = 0):
    """``n`` slot-pool steps (:func:`decode_burst` over
    :func:`batched_decode_step`). Slots that retire mid-burst decode
    garbage the host discards; their rows past the host's pos stay masked."""
    def step(tok, caches, p):
        return batched_decode_step(cfg, params, tok, caches, p, method, dtype)
    return decode_burst(step, caches, tokens, pos, generator, pres, temp,
                        topk, topp, penalty, n=n, tracking=tracking,
                        sampling=sampling, want_lp=want_lp, want_top=want_top)


class SamplingSlots:
    """Per-slot sampling state and token selection, shared by both engines.
    An all-greedy pool costs one argmax per step."""

    def _init_sampling(self, max_batch: int, vocab_size: int, seed: int):
        self.temp = np.zeros((max_batch,), np.float32)
        self.topk = np.full((max_batch,), vocab_size, np.int64)
        self.topp = np.ones((max_batch,), np.float32)
        self.penalty = np.ones((max_batch,), np.float32)
        # prompt+output presence on the device ([B, V] bool), built when
        # the first penalized request arrives and updated in place while
        # any penalty is live
        self._pres_dev: Optional[torch.Tensor] = None
        self._vocab = vocab_size
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device (an asynchronous copy of a
        private copy, so the host may change ``a`` at once)."""
        return torch.from_numpy(np.array(a)).to(self.device,
                                                non_blocking=True)

    def _tracking(self) -> bool:
        return bool(np.any(self.penalty != 1.0))

    def _rebuild_presence(self) -> None:
        pres = np.zeros((self.max_batch, self._vocab), bool)
        for slot, req in enumerate(self.slots):
            if req is not None:
                pres[slot, np.asarray(req.prompt, np.int64)] = True
                if req.output:
                    pres[slot, np.asarray(req.output, np.int64)] = True
        self._pres_dev = torch.from_numpy(pres).to(self.device)

    def _set_sampling(self, slot: int, req: "Request") -> None:
        v = self._vocab
        self.temp[slot] = req.temperature
        self.topk[slot] = (req.top_k if req.top_k and 0 < req.top_k < v
                           else v)
        self.topp[slot] = (req.top_p if req.top_p is not None
                           and req.top_p < 1.0 else 1.0)
        was_tracking = self._tracking()
        self.penalty[slot] = req.repetition_penalty or 1.0
        if self.penalty[slot] != 1.0:
            if not was_tracking or self._pres_dev is None:
                # presence went unmaintained while no penalty was live
                self._rebuild_presence()
            self._pres_dev[slot] = False
            self._pres_dev[slot, self._h2d(
                np.asarray(req.prompt, np.int64))] = True

    def _clear_sampling(self, slot: int) -> None:
        self.temp[slot] = 0.0  # a freed slot decodes (discarded) greedy
        self.penalty[slot] = 1.0

    def _note_token(self, slot: int, tok: int) -> None:
        """Admission-time single-token presence update."""
        if self._tracking():
            self._pres_dev[slot, tok] = True

    def _note_tokens_all(self, toks: torch.Tensor) -> None:
        """One pool step's tokens for every slot (rows of inactive or
        penalty-free slots are never read)."""
        if self._tracking():
            _presence_note(self._pres_dev, toks)

    def _sampling_args(self):
        return (self._h2d(self.temp), self._h2d(self.topk),
                self._h2d(self.topp))

    def _sample_pool(self, logits: torch.Tensor) -> torch.Tensor:
        """Pool-step token per slot, [B, V] logits -> [B] on the device."""
        if self._tracking():
            logits = _penalize_batched(logits, self._h2d(self.penalty),
                                       self._pres_dev)
        if not np.any(self.temp > 0.0):
            return torch.argmax(logits, dim=-1)
        return sample_batched(logits, *self._sampling_args(), self._gen)

    def _sample_slot(self, slot: int, logits_row: torch.Tensor) -> int:
        """Admission-time first token for one slot ([1, V] logits)."""
        if self.penalty[slot] != 1.0:
            logits_row = _penalize_batched(
                logits_row, self._h2d(self.penalty[slot: slot + 1]),
                self._pres_dev[slot: slot + 1])
        if self.temp[slot] == 0.0:
            return int(torch.argmax(logits_row[0]))
        return int(sample_batched(
            logits_row, self._h2d(self.temp[slot: slot + 1]),
            self._h2d(self.topk[slot: slot + 1]),
            self._h2d(self.topp[slot: slot + 1]), self._gen)[0])

    def _record_logprobs(self, logits, toks, slots) -> None:
        """Append each active slot's chosen-token logprob and, with
        ``top_logprobs=N``, the top-N alternatives (no-op unless
        ``return_logprobs``)."""
        if not self.return_logprobs:
            return
        lp = _token_logprobs(logits, toks).cpu().numpy()
        n = self.top_logprobs
        if n:
            vals, ids = (t.cpu().numpy() for t in _top_n_logprobs(logits, n))
        for slot in slots:
            req = self.slots[slot]
            if req is not None:
                req.logprobs.append(float(lp[slot]))
                if n:
                    req.top_logprobs.append(
                        {int(t): float(v)
                         for t, v in zip(ids[slot], vals[slot])})

    def _record_logprobs_slot(self, slot: int, req: "Request", logits_row,
                              tok: int) -> None:
        """Admission-time variant for one slot's [1, V] logits."""
        if not self.return_logprobs:
            return
        tok_t = torch.tensor([tok], device=logits_row.device)
        req.logprobs.append(float(_token_logprobs(logits_row, tok_t)[0]))
        n = self.top_logprobs
        if n:
            vals, ids = (t.cpu().numpy()[0]
                         for t in _top_n_logprobs(logits_row, n))
            req.top_logprobs.append({int(t): float(v)
                                     for t, v in zip(ids, vals)})

    def _replay_burst(self, active, toks, lps, tops) -> List[Tuple[Any, int]]:
        """Emission, logprobs and retirement of a burst's [B, n] tokens,
        token by token, as n single steps would have done them."""
        toks = toks.cpu().numpy()
        lps = None if lps is None else lps.cpu().numpy()
        if tops is not None:
            top_vals, top_ids = (t.cpu().numpy() for t in tops)
        emitted = []
        for i in range(toks.shape[1]):
            for slot in active:
                req = self.slots[slot]
                if req is None:
                    continue  # retired earlier in this burst
                tok = int(toks[slot, i])
                req.output.append(tok)
                if lps is not None:
                    req.logprobs.append(float(lps[slot, i]))
                if tops is not None:
                    req.top_logprobs.append(
                        {int(t): float(v) for t, v in
                         zip(top_ids[slot, i], top_vals[slot, i])})
                self._advance(slot, tok)
                if not req._stopped:
                    emitted.append((req.id, tok))
        return emitted

    def _burst(self, caches, n: int, decode):
        """Run ``decode(caches, tokens, pos, generator, presence, temp,
        topk, topp, penalty, n=, tracking=, sampling=, want_lp=,
        want_top=)`` (a burst of one engine) on this pool's state; returns
        (toks, lps, tops, caches) and keeps the presence."""
        tracking = self._tracking()
        pres = (self._pres_dev if tracking else
                torch.zeros((self.max_batch, 1), dtype=torch.bool,
                            device=self.device))
        toks, lps, tops, caches, pres = decode(
            caches, self._h2d(self.last_token), self._h2d(self.pos),
            self._gen, pres, *self._sampling_args(),
            self._h2d(self.penalty), n=n, tracking=tracking,
            sampling=bool(np.any(self.temp > 0.0)),
            want_lp=self.return_logprobs, want_top=self.top_logprobs)
        if tracking:
            self._pres_dev = pres
        return toks, lps, tops, caches

    # ------------------------------------------------- shared engine ops
    def cancel(self, req_id) -> bool:
        """Abort a request wherever it is: queued (dropped), in chunked
        prefill or active (slot and resources released). Returns whether
        anything was cancelled; the request does not join ``finished``.
        Not thread-safe: call from the thread that owns the engine."""
        for i, req in enumerate(self.queue):
            if req.id == req_id:
                del self.queue[i]
                return True
        for slot, st in list(self.inflight.items()):
            if st["req"].id == req_id:
                del self.inflight[slot]
                self._free_slot(slot)
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.id == req_id:
                self.slots[slot] = None
                self._free_slot(slot)
                return True
        return False

    def stats(self) -> Dict[str, Any]:
        """Operational snapshot (the HTTP /metrics payload)."""
        return {
            "slots_busy": sum(r is not None for r in self.slots),
            "slots_total": self.max_batch,
            "queued": len(self.queue),
            "prefilling": len(self.inflight),
            "finished": len(self.finished),
        }

    @property
    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.inflight)
                or any(s is not None for s in self.slots))

    @torch.inference_mode()
    def run(self, burst: int = 1) -> Dict[Any, List[int]]:
        """Drain all queued and active requests; returns id -> generated
        tokens. ``burst`` > 1 decodes that many tokens per step_burst once
        admissions settle (the same streams)."""
        while self.has_work:
            if burst > 1:
                self.step_burst(burst)
            else:
                self.step()
        return {r.id: r.output for r in self.finished}


class Request:
    def __init__(self, req_id: Any, prompt: np.ndarray,
                 max_new_tokens: int = 128, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 repetition_penalty: float = 1.0,
                 stop: Optional[List[List[int]]] = None,
                 prompt_embeds: Optional[torch.Tensor] = None):
        self.id = req_id
        self.prompt = np.asarray(prompt).reshape(-1)
        # a multimodal prompt: [S, H] input embeds (vision features spliced
        # at the image-token positions) replace the token embedding lookup
        # at prefill; decoding stays on token ids
        self.prompt_embeds = prompt_embeds
        self.max_new_tokens = max_new_tokens
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.repetition_penalty = float(repetition_penalty or 1.0)
        # per-request stop sequences (token-id lists); a match retires the
        # request and trims the matched suffix (OpenAI semantics)
        self.stop = [list(map(int, s)) for s in stop] if stop else []
        self._stopped = False
        self.output: List[int] = []
        self.logprobs: List[float] = []  # with return_logprobs=True
        self.top_logprobs: List[Dict[int, float]] = []  # with top_logprobs=N
        self.done = False

    def hit_stop(self) -> bool:
        """True when the output ends with a stop sequence; the longest
        matching suffix is trimmed (the earliest truncation point).
        Idempotent."""
        if self._stopped:
            return True
        best = 0
        for s in self.stop:
            if s and len(s) > best and len(self.output) >= len(s) \
                    and self.output[-len(s):] == s:
                best = len(s)
        if best:
            del self.output[-best:]
            del self.logprobs[len(self.output):]
            del self.top_logprobs[len(self.output):]
            self._stopped = True
            return True
        return False


class BatchingEngine(SamplingSlots):
    """FIFO continuous-batching scheduler over a fixed slot pool."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 max_batch: int = 8, max_seq_len: int = 2048,
                 eos_token_id: Optional[int] = None, method: str = "auto",
                 dtype: torch.dtype = torch.bfloat16,
                 prefill_chunk_size: Optional[int] = None,
                 kv_quant: bool = False, seed: int = 0,
                 return_logprobs: bool = False, top_logprobs: int = 0,
                 device=None):
        """``prefill_chunk_size`` bounds per-step admission work: long
        prompts prefill in fixed-size chunks interleaved with pool decode
        steps. ``None`` prefills each prompt whole at admission."""
        modules.check_supported(cfg)
        self.cfg, self.params = cfg, params
        self.max_batch, self.max_seq = max_batch, max_seq_len
        self.eos = eos_token_id
        self.method, self.dtype = method, dtype
        self.device = resolve_device(device)
        if prefill_chunk_size is not None \
                and max_seq_len % prefill_chunk_size != 0:
            # the final padded chunk must fit the row: a chunk-multiple
            # capacity guarantees it (prompts are below max_seq_len)
            raise ValueError(
                f"max_seq_len ({max_seq_len}) must be a multiple of "
                f"prefill_chunk_size ({prefill_chunk_size})")
        self.chunk = prefill_chunk_size
        self.kv_quant = kv_quant
        self.return_logprobs = return_logprobs or top_logprobs > 0
        self.top_logprobs = top_logprobs
        gen._check_rope_capacity(cfg, max_seq_len)
        self.caches = gen.init_kv_cache(cfg, max_batch, max_seq_len, dtype,
                                        self.device, kv_quant=kv_quant)
        self.pos = np.zeros((max_batch,), np.int64)
        self.last_token = np.zeros((max_batch,), np.int64)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.inflight: Dict[int, Dict[str, Any]] = {}  # slot -> prefill state
        self.queue: deque[Request] = deque()
        self.finished: List[Request] = []
        self._init_sampling(max_batch, cfg.vocab_size, seed)

    # -------------------------------------------------------- scheduling
    def add_request(self, req_id: Any, prompt, max_new_tokens: int = 128,
                    temperature: float = 0.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    repetition_penalty: float = 1.0,
                    stop: Optional[List[List[int]]] = None,
                    prompt_embeds=None):
        prompt = np.asarray(prompt).reshape(-1)
        if len(prompt) >= self.max_seq:
            raise ValueError("prompt longer than max_seq_len")
        prompt_embeds = prompt_rows(prompt_embeds, len(prompt), self.device)
        self.queue.append(Request(req_id, prompt, max_new_tokens,
                                  temperature, top_k, top_p,
                                  repetition_penalty, stop, prompt_embeds))

    def _new_row(self):
        return gen.init_kv_cache(self.cfg, 1, self.max_seq, self.dtype,
                                 self.device, kv_quant=self.kv_quant)

    def _free_slot(self, slot: int) -> None:
        self.pos[slot] = 0
        self._clear_sampling(slot)

    def _admit(self):
        for slot in range(self.max_batch):
            if (self.slots[slot] is not None or slot in self.inflight
                    or not self.queue):
                continue
            req = self.queue.popleft()
            if self.chunk is None or req.prompt_embeds is not None:
                # an embeds prompt prefills whole, as in JAX
                row = self._new_row()
                embeds = (None if req.prompt_embeds is None
                          else req.prompt_embeds[None])
                logits, row = gen.prefill(
                    self.cfg, self.params,
                    torch.as_tensor(req.prompt[None], dtype=torch.long,
                                    device=self.device),
                    row, self.method, self.dtype, embeds=embeds)
                self._activate(slot, req, row, logits)
            else:  # reserve the slot; chunks advance one per engine step
                self.inflight[slot] = {"req": req, "row": self._new_row(),
                                       "done": 0}

    def _activate(self, slot: int, req: Request, row, logits):
        self.caches = _install_slot(self.caches, row, slot)
        self._set_sampling(slot, req)
        tok = self._sample_slot(slot, logits[:1])
        self._note_token(slot, tok)
        self._record_logprobs_slot(slot, req, logits[:1], tok)
        req.output.append(tok)
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        self.last_token[slot] = tok
        self._retire_if_done(slot)

    def _advance_prefill(self):
        """One chunk for every in-flight admission."""
        for slot, st in list(self.inflight.items()):
            tail = advance_one_chunk(self.cfg, self.params, st, self.chunk,
                                     self.method, self.dtype)
            if tail is not None:
                del self.inflight[slot]
                self._activate(slot, st["req"], st["row"], tail)

    def _retire_if_done(self, slot: int):
        req = self.slots[slot]
        if req is None:
            return
        # stop first: a match completing exactly at the budget or EOS must
        # still be trimmed
        if (req.stop and req.hit_stop()) \
                or (req.output and req.output[-1] == self.eos) \
                or len(req.output) >= req.max_new_tokens \
                or self.pos[slot] + 1 >= self.max_seq:
            req.done = True
            self.finished.append(req)
            self.slots[slot] = None
            self._free_slot(slot)

    def _advance(self, slot: int, tok: int) -> None:
        """Host bookkeeping after a slot decoded ``tok``."""
        self.pos[slot] += 1
        self.last_token[slot] = tok
        self._retire_if_done(slot)

    # ------------------------------------------------------------- steps
    @torch.inference_mode()
    def step(self) -> List[Tuple[Any, int]]:
        """Admit waiting requests, advance in-flight chunked prefills by one
        chunk, then decode one token for every active slot. Returns the
        (request_id, token) pairs emitted this step."""
        self._admit()
        if self.inflight:
            self._advance_prefill()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        logits, self.caches = batched_decode_step(
            self.cfg, self.params, self._h2d(self.last_token[:, None]),
            self.caches, self._h2d(self.pos), self.method, self.dtype)
        toks_dev = self._sample_pool(logits)
        self._note_tokens_all(toks_dev)
        self._record_logprobs(logits, toks_dev, active)
        toks = toks_dev.cpu().numpy()
        emitted = []
        for slot in active:
            tok = int(toks[slot])
            req = self.slots[slot]
            req.output.append(tok)
            self._advance(slot, tok)
            if not req._stopped:
                # a stop match ends at this token, which was trimmed
                emitted.append((req.id, tok))
        return emitted

    @torch.inference_mode()
    def step_burst(self, n: int) -> List[Tuple[Any, int]]:
        """``n`` decode steps for the whole pool with no host read between
        them (:func:`batched_decode_burst`); emission, EOS / stop / budget
        retirement and logprobs replay on the host token by token, so the
        streams equal ``n`` single steps. Falls back to ``step()`` while
        admissions are pending."""
        self._admit()
        if self.inflight or n <= 1:
            return self.step()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        # no active slot may write past its cache row
        n = min(n, min(self.max_seq - 1 - int(self.pos[s]) for s in active))
        if n <= 1:
            return self.step()

        def decode(caches, *a, **kw):
            return batched_decode_burst(self.cfg, self.params, caches, *a,
                                        method=self.method, dtype=self.dtype,
                                        **kw)
        toks, lps, tops, self.caches = self._burst(self.caches, n, decode)
        return self._replay_burst(active, toks, lps, tops)
