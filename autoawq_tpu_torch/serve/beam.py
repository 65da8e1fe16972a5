"""Beam search with transformers' semantics; batched and sampled modes.

Counterpart of ``autoawq_tpu/serve/beam.py``. Every prompt's W beams live
as W rows of one [B·W]-row cache, each step is one decode over all beams
and a per-prompt top-2W over the flattened [W·V] scores, and the small
(B, 2W) candidate arrays come to the host, where transformers'
BeamSearchScorer runs: rank-filtered EOS hypotheses scored with the
generated length's penalty, ``early_stopping`` True / False / "never",
and a finalize that re-adds the running beams, sorts the hypotheses and
EOS-terminates and pads the returned rows. Cache rows follow their beams
through a gathered index after every step.

Selection sorts stably, so ties go to the lower flat index as
``lax.top_k`` breaks them (``torch.topk`` leaves tie order open). While
every row sits at one position (prompts of one length, none finished),
the step takes the contiguous decode with an int position, which at
B·W >= 8 is the fused attention step K5; otherwise per-row positions.

``do_sample=True`` draws the 2W candidates per prompt without replacement
by Gumbel-top-k over beam score + warped log-probabilities
(``warp_batched``); hypotheses still accumulate the model's own
log-probabilities. The draws come from a ``torch.Generator`` seeded with
``seed`` (JAX's PRNG draws differ).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.serve.batching import batched_decode_step, warp_batched
from autoawq_tpu_torch.utils.device import resolve_device


class _BeamHyps:
    """transformers' BeamHypotheses, on the host."""

    def __init__(self, num_beams: int, length_penalty: float,
                 early_stopping, max_length: int):
        self.num_beams = num_beams
        self.lp = length_penalty
        self.early_stopping = early_stopping
        self.max_length = max_length
        self.beams: List[Tuple[float, List[int]]] = []
        self.worst = 1e9

    def add(self, hyp: List[int], sum_logprobs: float, generated_len: int):
        score = sum_logprobs / (generated_len ** self.lp)
        if len(self.beams) < self.num_beams or score > self.worst:
            self.beams.append((score, list(hyp)))
            if len(self.beams) > self.num_beams:
                order = sorted(range(len(self.beams)),
                               key=lambda i: self.beams[i][0])
                del self.beams[order[0]]
                self.worst = min(s for s, _ in self.beams)
            else:
                self.worst = min(score, self.worst)

    def is_done(self, best_sum_logprobs: float, cur_len: int,
                prompt_len: int) -> bool:
        if len(self.beams) < self.num_beams:
            return False
        if self.early_stopping is True:
            return True
        if self.early_stopping is False:
            best = best_sum_logprobs / (cur_len - prompt_len) ** self.lp
            return self.worst >= best
        # "never"
        if self.lp > 0.0:
            best = best_sum_logprobs / (
                self.max_length - prompt_len) ** self.lp
        else:
            best = best_sum_logprobs / (cur_len - prompt_len) ** self.lp
        return self.worst >= best


def _top(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The n largest entries of each row, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def _select_2w(logp: torch.Tensor, beam_scores: torch.Tensor, b: int,
               w: int, do_sample: bool, temp: float, top_k: int,
               top_p: float, generator: torch.Generator):
    """Per-prompt candidates from [B·W, V] log-probs and beam scores
    [B, W]: ([B, 2W] true scores, beam index, token id). Deterministic:
    the top 2W of beam score + logp. Sampled: Gumbel-top-2W over beam
    score + warped logp, sorted by true score (positions the warpers cut
    get a score of -inf, which the scorer skips)."""
    v = logp.shape[-1]
    per_row = beam_scores.reshape(b * w, 1)
    flat = (per_row + logp).reshape(b, w * v)
    if not do_sample:
        scores, idx = _top(flat, 2 * w)
    else:
        rows = b * w
        dev = logp.device
        warped = warp_batched(
            logp, torch.full((rows,), temp, device=dev),
            torch.full((rows,), top_k, dtype=torch.long, device=dev),
            torch.full((rows,), top_p, device=dev))
        sel = (per_row + warped).reshape(b, w * v)
        u = torch.rand(sel.shape, generator=generator, device=dev)
        _, idx = _top(sel - torch.log(-torch.log(u)), 2 * w)
        scores = flat.gather(-1, idx)
        chosen = sel.gather(-1, idx)
        scores = torch.where(torch.isneginf(chosen), float("-inf"), scores)
        scores, order = _top(scores, 2 * w)
        idx = idx.gather(-1, order)
    return scores, idx // v, idx % v


def _beam_step(cfg, params, tokens, caches, pos, beam_scores, b: int,
               w: int, method: str, dtype, do_sample: bool, temp, top_k,
               top_p, generator):
    """One decode for all B·W rows (an int ``pos``: every row at it; a [B·W]
    tensor: per row) and the per-prompt candidate selection."""
    if isinstance(pos, int):
        logits, caches = gen.decode_step(cfg, params, tokens, caches, pos,
                                         method, dtype)
    else:
        logits, caches = batched_decode_step(cfg, params, tokens, caches,
                                             pos, method, dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, beams, toks = _select_2w(logp, beam_scores, b, w, do_sample,
                                     temp, top_k, top_p, generator)
    return scores, beams, toks, caches


def _gather_beams(caches, idx: torch.Tensor):
    """Reorder every cache row to its beam's source row, in place from a
    gathered copy."""
    for c in caches:
        for leaf in c.values():
            leaf.copy_(leaf[idx])
    return caches


@torch.inference_mode()
def generate_beam_batched(
    cfg: ModelConfig, params: Dict[str, Any], prompts: Sequence,
    max_new_tokens: int, *, num_beams: int = 4,
    length_penalty: float = 1.0, early_stopping=False,
    eos_token_id: Optional[int] = None, method: str = "auto",
    dtype: torch.dtype = torch.bfloat16, max_seq_len: Optional[int] = None,
    num_return_sequences: int = 1, do_sample: bool = False,
    temperature: float = 1.0, top_k: Optional[int] = None,
    top_p: Optional[float] = None, seed: int = 0, device=None
) -> List[Tuple[np.ndarray, List[float]]]:
    """Beam search over a batch of prompts (1-D token ids, ragged lengths
    fine) in one beam-row pool on ``device`` (None: the card). Returns,
    per prompt, ([num_return_sequences, L] int64 sequences, best first,
    EOS-terminated and padded as transformers pads them, and their
    sequence scores). Prompts finish independently; a finished prompt's
    rows idle until the last one finishes."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1 (a zero-length "
                         "generation has no hypothesis to score)")
    w = num_beams
    if not 1 <= num_return_sequences <= w:
        raise ValueError("num_return_sequences must be in [1, num_beams]")
    if do_sample and not temperature > 0.0:
        raise ValueError("do_sample=True needs temperature > 0")
    dev = resolve_device(device)
    prompts = [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p
                          ).reshape(-1) for p in prompts]
    b = len(prompts)
    lens = [len(p) for p in prompts]
    temperature = float(temperature)
    top_k = int(top_k) if top_k else cfg.vocab_size
    top_p = float(top_p) if top_p is not None else 1.0
    total = max_seq_len or (max(lens) + max_new_tokens)
    gen._check_rope_capacity(cfg, total)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    # prefill each prompt into a row cache, then build the [B·W]-row pool
    rows, logp0 = [], []
    for p in prompts:
        row = gen.init_kv_cache(cfg, 1, total, dtype, dev)
        logits0, row = gen.prefill(
            cfg, params, torch.as_tensor(p[None], dtype=torch.long,
                                         device=dev), row, method, dtype)
        logp0.append(torch.log_softmax(logits0[0].float(), dim=-1))
        rows.append(row)
    caches = [{key: torch.cat([r[li][key].repeat_interleave(w, 0)
                               for r in rows])
               for key in rows[0][li]} for li in range(len(rows[0]))]
    del rows

    hyps = [_BeamHyps(w, length_penalty, early_stopping,
                      lens[i] + max_new_tokens) for i in range(b)]
    beam_scores = np.full((b, w), -1e9, np.float32)
    beam_scores[:, 0] = 0.0
    seqs: List[List[List[int]]] = [[list(p)] * w for p in prompts]
    tokens = np.zeros((b, w), np.int64)
    pos = np.asarray([lens[i] for i in range(b) for _ in range(w)],
                     np.int64)
    done = [False] * b

    for step in range(max_new_tokens):
        if step == 0:  # the prompts' own prefill logits
            sel = [_select_2w(logp0[i][None].expand(w, -1),
                              torch.from_numpy(beam_scores[i][None]).to(dev),
                              1, w, do_sample, temperature, top_k, top_p, g)
                   for i in range(b)]
            scores2w, beams2w, toks2w = (
                torch.cat(t).cpu().numpy() for t in zip(*sel))
        else:
            at = int(pos[0]) if bool((pos == pos[0]).all()) else \
                torch.from_numpy(pos).to(dev)
            scores2w, beams2w, toks2w, caches = _beam_step(
                cfg, params,
                torch.from_numpy(tokens.reshape(-1, 1)).to(dev), caches, at,
                torch.from_numpy(beam_scores).to(dev), b, w, method, dtype,
                do_sample, temperature, top_k, top_p, g)
            scores2w, beams2w, toks2w = (t.cpu().numpy() for t in
                                         (scores2w, beams2w, toks2w))

        gather_idx = np.arange(b * w)
        for i in range(b):
            if done[i]:
                continue  # rows idle: pos frozen, outputs ignored
            cur_len = lens[i] + step + 1
            nxt: List[Tuple[int, float, int]] = []
            for rank in range(2 * w):
                t, sc, bm = (int(toks2w[i, rank]), float(scores2w[i, rank]),
                             int(beams2w[i, rank]))
                if not np.isfinite(sc):
                    continue  # a position the warpers cut
                if eos_token_id is not None and t == eos_token_id:
                    if rank >= w:
                        continue
                    hyps[i].add(seqs[i][bm], sc, cur_len - lens[i])
                else:
                    nxt.append((t, sc, bm))
                if len(nxt) == w:
                    break
            if not nxt:  # every finite candidate was EOS: the prompt is done
                done[i] = True
                continue
            while len(nxt) < w:  # the warpers starved the pool
                nxt.append(nxt[-1])
            done[i] = done[i] or hyps[i].is_done(
                float(scores2w[i, 0]), cur_len, lens[i])
            seqs[i] = [seqs[i][bm] + [t] for t, _, bm in nxt]
            beam_scores[i] = [sc for _, sc, _ in nxt]
            tokens[i] = [t for t, _, _ in nxt]
            gather_idx[i * w: (i + 1) * w] = [i * w + bm for _, _, bm in nxt]
            if step >= 1:
                # step `step` decoded at lens + step - 1; the step-0
                # candidates came from the prefill, so the first decode
                # still writes at lens
                pos[i * w: (i + 1) * w] += 1
        if all(done):
            break
        if step + 1 < max_new_tokens:
            caches = _gather_beams(caches, torch.from_numpy(gather_idx).to(
                dev))

    out: List[Tuple[np.ndarray, List[float]]] = []
    for i in range(b):
        if not done[i]:  # finalize: running beams become hypotheses
            for j in range(w):
                hyps[i].add(seqs[i][j], float(beam_scores[i][j]),
                            len(seqs[i][j]) - lens[i])
        best = sorted(hyps[i].beams, key=lambda x: -x[0])
        best = best[:num_return_sequences]
        max_len = lens[i] + max_new_tokens
        rows_i, scores = [], []
        for sc, seq in best:
            seq = list(seq)
            # transformers appends EOS to a sequence that ended early, then
            # pads the returned rows to one length
            if eos_token_id is not None and len(seq) < max_len:
                seq = seq + [eos_token_id]
            rows_i.append(seq)
            scores.append(sc)
        ln = max(len(r) for r in rows_i)
        pad = eos_token_id if eos_token_id is not None else 0
        rows_i = [r + [pad] * (ln - len(r)) for r in rows_i]
        out.append((np.asarray(rows_i, np.int64), scores))
    return out


def generate_beam(
    cfg: ModelConfig, params: Dict[str, Any], prompt: torch.Tensor,
    max_new_tokens: int, *, num_beams: int = 4, length_penalty: float = 1.0,
    early_stopping=False, eos_token_id: Optional[int] = None,
    method: str = "auto", dtype: torch.dtype = torch.bfloat16,
    max_seq_len: Optional[int] = None, do_sample: bool = False,
    temperature: float = 1.0, top_k: Optional[int] = None,
    top_p: Optional[float] = None, seed: int = 0
) -> Tuple[torch.Tensor, float]:
    """Beam search for one prompt [1, S] on its device: ([1, L] best
    sequence, padded as transformers pads it, and its score)."""
    if prompt.shape[0] != 1:
        raise NotImplementedError(
            "generate_beam wraps one prompt; use generate_beam_batched")
    [(rows, scores)] = generate_beam_batched(
        cfg, params, [prompt[0]], max_new_tokens, num_beams=num_beams,
        length_penalty=length_penalty, early_stopping=early_stopping,
        eos_token_id=eos_token_id, method=method, dtype=dtype,
        max_seq_len=max_seq_len, do_sample=do_sample,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        device=prompt.device)
    return torch.from_numpy(rows[:1]).to(prompt.device), scores[0]
