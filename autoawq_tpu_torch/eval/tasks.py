"""Multiple-choice (MMLU-style) evaluation and word error rate.

Counterpart of ``autoawq_tpu/eval/tasks.py`` (``_seq_logprobs`` :24,
``choice_loglikelihood`` :34, ``format_mmlu_prompt`` :58,
``eval_multiple_choice`` :70, ``load_mmlu`` :107, ``word_error_rate`` :124,
``eval_librispeech`` :143). Reference analogues: ``eval_mmlu``
(awq/evaluation/eval_utils.py:117-164, which defers to lm-eval) and
``eval_librispeech`` (eval_utils.py:61-114, whisper + jiwer). Here
multiple-choice scoring runs on the port's model through summed
continuation log-likelihoods, on the device the parameters are on, and
WER ships its own edit distance. ``load_mmlu`` and ``eval_librispeech``
import ``datasets`` / ``transformers`` when called.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules


@torch.inference_mode()
def _seq_logprobs(cfg: ModelConfig, params: Dict[str, Any],
                  tokens: torch.Tensor, method: str = "auto"
                  ) -> torch.Tensor:
    """Per-position next-token log-probs [B, S - 1] of a [B, S] batch."""
    logits = modules.forward(cfg, params, tokens, method=method)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None])[..., 0]


def choice_loglikelihood(cfg: ModelConfig, params: Dict[str, Any],
                         context_ids: Sequence[int],
                         continuation_ids: Sequence[int],
                         pad_to: Optional[int] = None,
                         method: str = "auto") -> float:
    """Sum of log P(continuation | context): lm-eval's "loglikelihood"
    primitive of MMLU / ARC / HellaSwag-style tasks. ``pad_to`` pads the
    sequence on the right (JAX's stable jit shapes; the causal model's
    rows before the pad do not see it)."""
    ids = list(context_ids) + list(continuation_ids)
    seq = np.asarray(ids, np.int64)[None]
    if pad_to and seq.shape[1] < pad_to:
        seq = np.pad(seq, ((0, 0), (0, pad_to - seq.shape[1])))
    dev = params["embed_tokens"]["weight"].device
    lp = _seq_logprobs(cfg, params, torch.from_numpy(seq).to(dev), method)
    start = len(context_ids) - 1
    return float(lp[0, start:start + len(continuation_ids)].sum())


MMLU_CHOICES = ("A", "B", "C", "D")


def format_mmlu_prompt(question: str, choices: Sequence[str],
                       subject: str = "") -> str:
    subj = subject.replace("_", " ")
    head = (f"The following are multiple choice questions (with answers) "
            f"about {subj}.\n\n" if subject else "")
    body = question.strip() + "\n"
    for letter, choice in zip(MMLU_CHOICES, choices):
        body += f"{letter}. {choice}\n"
    return head + body + "Answer:"


def eval_multiple_choice(cfg: ModelConfig, params: Dict[str, Any],
                         tokenizer, examples: List[Dict[str, Any]],
                         subject: str = "", method: str = "auto",
                         progress: bool = False) -> Dict[str, float]:
    """Accuracy by the largest continuation log-likelihood over the answer
    letters (lm-eval's MMLU recipe without the harness); ``examples`` are
    {"question", "choices", "answer" (int)}."""
    it = examples
    if progress:
        try:
            from tqdm import tqdm

            it = tqdm(examples, desc="mmlu", unit="q")
        except ImportError:
            pass
    correct = 0
    for ex in it:
        prompt = format_mmlu_prompt(ex["question"], ex["choices"], subject)
        ctx = tokenizer(prompt)["input_ids"]
        conts = [tokenizer(" " + letter, add_special_tokens=False)["input_ids"]
                 for letter in MMLU_CHOICES[:len(ex["choices"])]]
        pad_to = max(len(ctx) + len(c) for c in conts)
        scores = [choice_loglikelihood(cfg, params, ctx, cont,
                                       pad_to=pad_to, method=method)
                  for cont in conts]
        if int(np.argmax(scores)) == int(ex["answer"]):
            correct += 1
    return {"accuracy": correct / max(1, len(examples)),
            "n": len(examples)}


def load_mmlu(subjects: Optional[List[str]] = None, split: str = "test",
              n_per_subject: Optional[int] = None):
    """cais/mmlu through ``datasets`` (needs the network)."""
    from datasets import load_dataset

    out: Dict[str, List[Dict[str, Any]]] = {}
    for s in subjects or ["all"]:
        rows = [dict(r) for r in load_dataset("cais/mmlu", s, split=split)]
        out[s] = rows[:n_per_subject] if n_per_subject else rows
    return out


# --------------------------------------------------------------------------
# Word error rate (LibriSpeech-style ASR evaluation)
# --------------------------------------------------------------------------

def word_error_rate(references: Sequence[str],
                    hypotheses: Sequence[str]) -> float:
    """Corpus WER by Levenshtein distance over words."""
    errors = total = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        d = np.zeros((len(r) + 1, len(h) + 1), np.int32)
        d[:, 0] = np.arange(len(r) + 1)
        d[0, :] = np.arange(len(h) + 1)
        for i in range(1, len(r) + 1):
            for j in range(1, len(h) + 1):
                sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
                d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
        errors += int(d[len(r), len(h)])
        total += len(r)
    return errors / max(1, total)


def eval_librispeech(model_id: str, n_samples: int = 100) -> Dict[str, float]:
    """Whisper-family WER on LibriSpeech test.clean through the HF
    pipeline, the reference's recipe (eval_utils.py:61-114); needs the
    network and transformers' audio dependencies."""
    from datasets import load_dataset
    from transformers import pipeline

    ds = load_dataset("librispeech_asr", "clean", split="test",
                      streaming=True)
    pipe = pipeline("automatic-speech-recognition", model=model_id)
    refs, hyps = [], []
    for i, sample in enumerate(ds):
        if i >= n_samples:
            break
        refs.append(sample["text"].lower().strip())
        hyps.append(pipe(sample["audio"])["text"].lower().strip())
    return {"wer": word_error_rate(refs, hyps), "n": len(refs)}
