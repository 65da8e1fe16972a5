"""Calibration data (AutoAWQ's ``awq/utils/calib_data.py`` semantics).

The port's copy of ``autoawq_tpu/quantize/calib.py`` (``get_calib_dataset``
:18). Accepts a dataset name (``"pileval"`` by default; needs the
``datasets`` package and a download), a list of strings (tokenized here), a
list of token-id lists, or a pre-tokenized 2-D array. Shuffle (seed 42),
drop samples longer than ``max_seq_len``, keep the first ``n_samples``
survivors, concatenate, and cut into ``[*, max_seq_len]`` blocks.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Union

import numpy as np


def get_calib_dataset(
    data: Union[str, Sequence[Any], np.ndarray] = "pileval",
    tokenizer=None,
    n_samples: int = 128,
    max_seq_len: int = 512,
    split: str = "train",
    text_column: str = "text",
    seed: int = 42,
    filter_long_samples: bool = True,
) -> np.ndarray:
    """``filter_long_samples=True`` is AutoAWQ's behaviour: samples longer
    than ``max_seq_len`` never enter the stream, so calibration on the same
    dataset sees AutoAWQ's blocks. ``False`` keeps everything."""
    if isinstance(data, np.ndarray):
        if data.ndim != 2:
            raise ValueError("pre-tokenized array must be [n, seq_len]")
        return np.asarray(data[:n_samples])  # already blocked: use as is
    elif isinstance(data, str):
        texts = _load_hf_texts(data, split, text_column, n_samples * 8, seed)
        ids = [np.asarray(tokenizer(t)["input_ids"]) for t in texts]
    elif len(data) and isinstance(data[0], str):
        if tokenizer is None:
            raise ValueError("tokenizer required for string calibration data")
        ids = [np.asarray(tokenizer(t)["input_ids"]) for t in data]
    else:  # a list of token-id lists
        ids = [np.asarray(t) for t in data]

    # skip empty and too-long samples, stop after n_samples survivors
    kept: List[np.ndarray] = []
    for t in ids:
        t = t.reshape(-1)
        if t.size == 0:
            continue
        if filter_long_samples and t.size > max_seq_len:
            continue
        kept.append(t)
        if len(kept) == n_samples:
            break
    if not kept:
        raise ValueError("no calibration samples survive the length filter")

    # concatenate and cut into max_seq_len blocks
    cat = np.concatenate(kept)
    n_blocks = cat.size // max_seq_len
    if not filter_long_samples:
        n_blocks = min(n_samples, n_blocks)
    if n_blocks == 0:
        raise ValueError(
            f"calibration data too short: {cat.size} tokens < {max_seq_len}")
    return cat[: n_blocks * max_seq_len].reshape(n_blocks, max_seq_len)


def _load_hf_texts(name: str, split: str, text_column: str, limit: int,
                   seed: int) -> List[str]:
    from datasets import load_dataset

    if name == "pileval":
        ds = load_dataset("mit-han-lab/pile-val-backup", split="validation")
    else:
        ds = load_dataset(name, split=split)
    ds = ds.shuffle(seed=seed)
    out = []
    for row in ds:
        t = row[text_column].strip()
        if t:
            out.append(t)
        if len(out) >= limit:
            break
    return out
