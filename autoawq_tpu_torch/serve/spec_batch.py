"""Speculative continuous batching: draft-propose / target-verify for a
whole slot pool.

Counterpart of ``autoawq_tpu/serve/spec_batch.py``: the slot pool of
``serve/batching.py`` with ``serve/speculative.py``'s scheme, pool-wide.

* The draft proposes k tokens for every slot with k pool decode steps on
  its own slot-pool cache, plus one catch-up step that writes the last
  proposal's row (``draft_burst``, a loop over ``batched_decode_step``
  with no host read inside; JAX runs it as a ``lax.scan``).
* The target scores every slot's ``[last, d_1..d_k]`` in one pool forward
  (``batched_chunk_step``: per-slot offsets, causal within each chunk),
  writing the rows through ``nn/modules._cache_write``'s index tensors.
* Acceptance is per slot (``pool_accept``; an all-greedy pool only
  ``greedy_accept``): greedy slots keep the longest prefix matching the
  target's argmax, so their streams equal the plain
  ``BatchingEngine``'s; sampled slots run speculative sampling on the
  device with the warpers of ``warp_batched`` for both q and p, so their
  streams are distributed as the plain pool's sampling. The draws come
  from the engine's ``torch.Generator`` (JAX's PRNG draws differ).

A round that would write past a slot's cache row falls back to one plain
pool step and mirrors the consumed token into the draft cache (the
capacity fallback, JAX's semantics, counted in ``capacity_fallbacks``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.serve.batching import (BatchingEngine, Request,
                                              _install_slot,
                                              _penalize_batched,
                                              _presence_note,
                                              _top_n_logprobs,
                                              batched_decode_step,
                                              sample_batched, warp_batched)


def batched_chunk_step(cfg: ModelConfig, params: Dict[str, Any],
                       tokens: torch.Tensor, caches, pos: torch.Tensor,
                       method: str = "auto",
                       dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, Any]:
    """C tokens [B, C] for every slot at its own offset pos [B] (on the
    device), causal within each chunk; returns ([B, C, V] f32 logits,
    caches)."""
    c = tokens.shape[1]
    max_t = gen._cache_len(caches)
    dev = pos.device
    positions = pos[:, None] + torch.arange(c, device=dev)[None, :]
    x = modules.embed(cfg, params, tokens, dtype, positions)
    ki = torch.arange(max_t, device=dev)
    ok = ki[None, None, :] <= positions[:, :, None]  # [B, C, T]
    if cfg.sliding_window:
        ok = ok & (ki[None, None, :]
                   > positions[:, :, None] - cfg.sliding_window)
    mask = torch.where(ok, 0.0, -1e30).float()[:, None]
    if cfg.pos_embed == "alibi":
        rel = (ki[None, None, :] - positions[:, :, None]).float()
        slopes = modules.head_slopes(cfg, dev)
        mask = mask + slopes[None, :, None, None] * rel[:, None]
    cos, sin = modules.rope_tables(cfg, positions, seq_len=max_t)
    for lp, cache in zip(params["layers"], caches):
        x, _ = modules.block(cfg, lp, x, cos, sin, mask,
                             kv_cache={**cache, "pos": pos}, method=method)
    return modules.logits_fn(cfg, params, x, method), caches


def greedy_accept(tlog: torch.Tensor, drafts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy acceptance for every slot on the device: the longest prefix
    of drafts [B, k] matching the argmax of the chunk logits tlog
    [B, k+1, V], and the argmax after it. Returns ([B] accepted counts,
    [B] next tokens)."""
    k = drafts.shape[1]
    g = torch.argmax(tlog, dim=-1)  # [B, k + 1]
    match = drafts.long() == g[:, :k]
    a = torch.where(match.all(-1), torch.full_like(g[:, 0], k),
                    torch.argmin(match.int(), -1))
    return a, g.gather(1, a[:, None])[:, 0]


def pool_accept(tlog: torch.Tensor, dlog: torch.Tensor,
                drafts: torch.Tensor, temp: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor,
                generator: torch.Generator
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot acceptance for the whole pool on the device: tlog
    [B, k+1, V] the target's chunk logits, dlog [B, k, V] the draft logits
    the proposals drafts [B, k] came from, per-slot warpers (temp 0 =
    greedy). Returns ([B] accepted counts, [B] next tokens).

    Sampled slots: accept d_i with probability min(1, p_i(d_i) / q_i(d_i)),
    resample the first rejection from normalize(max(p - q, 0)); an
    all-accepted slot draws from p_k, which padding q with a zero row at
    index k expresses uniformly; an empty residual samples p. Greedy slots:
    ``greedy_accept``."""
    b, kp1, v = tlog.shape
    k = kp1 - 1

    def warped_probs(lg, n):
        w = warp_batched(lg.float().reshape(b * n, v),
                         temp.repeat_interleave(n),
                         top_k.repeat_interleave(n),
                         top_p.repeat_interleave(n))
        return torch.softmax(w, dim=-1).reshape(b, n, v)

    p = warped_probs(tlog, kp1)
    q = warped_probs(dlog, k)
    d = drafts.long()[..., None]
    p_d = p[:, :k].gather(-1, d)[..., 0]
    q_d = q.gather(-1, d)[..., 0]
    u = torch.rand((b, k), generator=generator, device=tlog.device)
    rej = u >= p_d / q_d.clamp_min(1e-30)  # [B, k]
    # the first rejection (argmax returns the first maximal index)
    a_s = torch.where(rej.any(-1), torch.argmax(rej.int(), -1),
                      torch.full_like(rej[:, 0], k, dtype=torch.long))
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    at = a_s[:, None, None].expand(b, 1, v)
    p_a = p.gather(1, at)[:, 0]
    q_a = q_pad.gather(1, at)[:, 0]
    residual = (p_a - q_a).clamp_min(0.0)
    residual = torch.where(residual.sum(-1, keepdim=True) > 1e-12,
                           residual, p_a)
    nxt_s = torch.multinomial(residual, 1, generator=generator)[:, 0]
    a_g, nxt_g = greedy_accept(tlog, drafts)
    greedy = temp <= 0.0
    return (torch.where(greedy, a_g, a_s), torch.where(greedy, nxt_g, nxt_s))


def draft_burst(dcfg: ModelConfig, dparams: Dict[str, Any], dcaches,
                tok0: torch.Tensor, dpos: torch.Tensor,
                generator: torch.Generator, pres: torch.Tensor,
                temp: torch.Tensor, topk: torch.Tensor, topp: torch.Tensor,
                penalty: torch.Tensor, *, k: int, method: str = "auto",
                dtype: torch.dtype = torch.bfloat16, sampling: bool = False,
                tracking: bool = False):
    """The draft phase in one loop with no host read: k proposals for every
    slot from tok0 [B] at dpos [B], then the catch-up step that writes the
    last proposal's row (its logits unused). The repetition penalty reads
    a local copy of the presence with the burst's own proposals noted.
    Returns (drafts [B, k], draft logits [B, k, V] when ``sampling`` else
    None, dcaches)."""
    if tracking:
        pres = pres.clone()  # the engine's presence stays as it is
    toks, dlogs = [], []
    tok = tok0
    for i in range(k + 1):
        dlog, dcaches = batched_decode_step(dcfg, dparams, tok[:, None],
                                            dcaches, dpos + i, method, dtype)
        if i == k:
            break  # the catch-up step only writes the draft cache
        if tracking:
            dlog = _penalize_batched(dlog, penalty, pres)
        if sampling:
            tok = sample_batched(dlog, temp, topk, topp, generator)
            dlogs.append(dlog)
        else:
            tok = torch.argmax(dlog, dim=-1)
        if tracking:
            pres = _presence_note(pres, tok)
        toks.append(tok)
    return (torch.stack(toks, 1),
            torch.stack(dlogs, 1) if sampling else None, dcaches)


def _penalize_chunk(logits: torch.Tensor, penalty: torch.Tensor,
                    presence: torch.Tensor,
                    drafts: torch.Tensor) -> torch.Tensor:
    """HF repetition penalty across a verify chunk ([B, C, V] logits):
    row i scores the token after drafts[:, :i], so its presence is the
    slot's prompt and output plus the chunk's earlier proposals (JAX's
    ``associative_scan`` of OR is a cumulative sum here)."""
    b, c, v = logits.shape
    oh = torch.nn.functional.one_hot(drafts.long(), v)  # [B, C-1, V]
    seen = oh.cumsum(1) > 0
    pres = torch.cat([torch.zeros_like(seen[:, :1]), seen], dim=1) \
        | presence[:, None]
    pen = penalty[:, None, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(pres & (pen != 1.0), penalized, logits)


def _spec_logprobs(tlog: torch.Tensor, drafts: torch.Tensor,
                   a: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """[B, k+1] log p(emitted token) under the unwarped chunk logits: row
    i scores drafts[i] for i < a and the next token at row a (rows past a
    are never read)."""
    b = tlog.shape[0]
    toks = torch.cat([drafts.long(), torch.zeros_like(drafts[:, :1]).long()],
                     dim=1)
    toks[torch.arange(b, device=tlog.device), a.long()] = nxt.long()
    lsm = torch.log_softmax(tlog.float(), dim=-1)
    return lsm.gather(-1, toks[..., None])[..., 0]


class SpeculativeBatchingEngine(BatchingEngine):
    """Slot-pool serving where every round proposes with a draft model and
    verifies with the target: per-slot acceptance, any mix of greedy and
    sampled requests. The target admits as ``BatchingEngine`` does (chunked
    prefill, int8 caches, MLA latent caches); the draft, small by design,
    prefills each prompt whole at activation. A ``prompt_embeds`` request
    prefills the target from its embeds and the draft, which has its own
    width, from the prompt's ids (placeholder ids at the image rows)."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 draft_cfg: ModelConfig, draft_params: Dict[str, Any],
                 k: int = 4, **kw):
        super().__init__(cfg, params, **kw)
        if cfg.vocab_size != draft_cfg.vocab_size:
            raise ValueError("draft and target must share a tokenizer")
        modules.check_supported(draft_cfg)
        self.dcfg, self.dparams = draft_cfg, draft_params
        self.k = k
        self.dcaches = gen.init_kv_cache(draft_cfg, self.max_batch,
                                         self.max_seq, self.dtype,
                                         self.device)
        self.dpos = np.zeros((self.max_batch,), np.int64)
        self.accepted = self.proposed = 0
        self.draft_steps = self.capacity_fallbacks = 0

    def _activate(self, slot: int, req: Request, row, logits):
        drow = gen.init_kv_cache(self.dcfg, 1, self.max_seq, self.dtype,
                                 self.device)
        _, drow = gen.prefill(self.dcfg, self.dparams,
                              torch.as_tensor(req.prompt[None],
                                              dtype=torch.long,
                                              device=self.device),
                              drow, self.method, self.dtype)
        self.dcaches = _install_slot(self.dcaches, drow, slot)
        self.dpos[slot] = len(req.prompt)
        super()._activate(slot, req, row, logits)

    def _emit(self, slot: int, toks: List[int], emitted, lps=None,
              tops=None) -> None:
        """Append a round's tokens for one slot, stopping at EOS, the
        budget, a stop sequence or the cache's end."""
        req = self.slots[slot]
        n0 = len(req.output)
        appended = 0
        for j, t in enumerate(toks):
            req.output.append(t)
            appended += 1
            self._note_token(slot, t)  # keep the penalty presence current
            if lps is not None:
                req.logprobs.append(float(lps[j]))
            if tops is not None:
                req.top_logprobs.append(tops[j])
            emitted.append((req.id, t))
            self.pos[slot] += 1
            self.last_token[slot] = t
            if ((req.stop and req.hit_stop()) or t == self.eos
                    or len(req.output) >= req.max_new_tokens
                    or self.pos[slot] + 1 >= self.max_seq):
                break
        if req._stopped:
            # withdraw the pairs the stop trim removed (only this call's;
            # a match spanning an earlier round is the server's to trim)
            trimmed = appended - (len(req.output) - n0)
            for _ in range(min(trimmed, appended)):
                emitted.pop()
        # rows past a mid-round stop are stale and masked by pos
        self.dpos[slot] = self.pos[slot]
        self._retire_if_done(slot)

    def _fallback_step(self) -> List[Tuple[Any, int]]:
        """One plain pool step, then the consumed token mirrored into the
        draft cache (each active slot's output[-2] at pos - 1, read after
        the step, which may have activated slots), so the draft stays in
        step when speculative rounds resume."""
        self.capacity_fallbacks += 1
        emitted = super().step()
        tok_m = np.zeros_like(self.last_token)
        pos_m = np.zeros_like(self.pos)
        for slot, req in enumerate(self.slots):
            if req is not None and len(req.output) >= 2:
                tok_m[slot] = req.output[-2]
                pos_m[slot] = self.pos[slot] - 1
        _, self.dcaches = batched_decode_step(
            self.dcfg, self.dparams, self._h2d(tok_m[:, None]), self.dcaches,
            self._h2d(pos_m), self.method, self.dtype)
        self.draft_steps += 1
        self.dpos = self.pos.copy()
        return emitted

    @torch.inference_mode()
    def step(self) -> List[Tuple[Any, int]]:
        """Admit, advance chunked admissions, then one speculative round for
        every active slot. Returns the (request id, token) pairs emitted."""
        self._admit()
        if self.inflight:
            self._advance_prefill()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        k = self.k
        # a full round needs k + 1 cache rows past pos
        if int(self.pos[active].max()) + k + 2 >= self.max_seq:
            return self._fallback_step()

        sampling = bool(np.any(self.temp > 0.0))
        tracking = self._tracking()
        pen = self._h2d(self.penalty)
        pres0 = (self._pres_dev if tracking else
                 torch.zeros((self.max_batch, 1), dtype=torch.bool,
                             device=self.device))
        warpers = self._sampling_args()
        drafts_d, qlogs, self.dcaches = draft_burst(
            self.dcfg, self.dparams, self.dcaches,
            self._h2d(self.last_token), self._h2d(self.dpos), self._gen,
            pres0, *warpers, pen, k=k, method=self.method, dtype=self.dtype,
            sampling=sampling, tracking=tracking)
        self.draft_steps += k + 1
        drafts = drafts_d.cpu().numpy()

        chunk = np.concatenate([self.last_token[:, None], drafts], axis=1)
        tlog, self.caches = batched_chunk_step(
            self.cfg, self.params, self._h2d(chunk), self.caches,
            self._h2d(self.pos), self.method, self.dtype)
        # acceptance reads the penalized logits (processor before warpers);
        # logprobs report the raw ones, as the plain engine does
        tlog_acc = (_penalize_chunk(tlog, pen, self._pres_dev, drafts_d)
                    if tracking else tlog)
        if sampling:
            acc_d, nxt_d = pool_accept(tlog_acc, qlogs, drafts_d, *warpers,
                                       self._gen)
        else:
            acc_d, nxt_d = greedy_accept(tlog_acc, drafts_d)
        acc, nxt = acc_d.cpu().numpy(), nxt_d.cpu().numpy()
        lp_mat = None
        if self.return_logprobs:
            lp_mat = _spec_logprobs(tlog, drafts_d, self._h2d(acc),
                                    self._h2d(nxt)).cpu().numpy()
        top_vals = top_ids = None
        if self.top_logprobs:
            top_vals, top_ids = (t.cpu().numpy() for t in _top_n_logprobs(
                tlog, self.top_logprobs))

        emitted: List[Tuple[Any, int]] = []
        for slot in active:
            a = int(acc[slot])
            new = [int(t) for t in drafts[slot, :a]] + [int(nxt[slot])]
            self.accepted += a
            self.proposed += k
            tops = None
            if top_vals is not None:
                tops = [{int(t): float(v) for t, v in
                         zip(top_ids[slot, j], top_vals[slot, j])}
                        for j in range(a + 1)]
            self._emit(slot, new, emitted,
                       None if lp_mat is None else lp_mat[slot], tops)
        return emitted

    def step_burst(self, n: int) -> List[Tuple[Any, int]]:
        """One round: a round already emits up to k + 1 tokens a slot, and
        a plain decode burst would leave the draft cache behind."""
        return self.step()

    @property
    def accept_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)
