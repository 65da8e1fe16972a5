"""The port's command line (``python -m autoawq_tpu_torch``) against the
JAX package's (``python -m autoawq_tpu``): the same subcommands, flags and
defaults, plus ``--device``; ``generate`` and ``benchmark`` run on a tiny
saved checkpoint with ``--device cpu`` and a tokenizer built locally with
``tokenizers`` (no download). Then ``utils/profiling``: ``trace`` /
``summarize_trace`` over a CPU forward, and the NaN checks."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from autoawq_tpu import __main__ as jcli
from autoawq_tpu_torch import __main__ as cli
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.io import serialize
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.utils import profiling
from autoawq_tpu_torch.utils.synth import random_quantized_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(model_type="llama", vocab_size=64, hidden_size=64,
             intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=128)
WORDS = ["<unk>", "</s>", "the", "meaning", "of", "life", "is", "a", "cat",
         "sat", "on", "mat"]
WORDS += [f"w{i}" for i in range(len(WORDS), LLAMA["vocab_size"])]


class _Stop(Exception):
    pass


def _jax_parser(monkeypatch):
    """The parser JAX's ``main`` builds, caught at ``parse_args``."""
    seen = {}

    def grab(self, *a, **k):
        seen["parser"] = self
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Stop):
            jcli.main([])
    return seen["parser"]


def _commands(parser):
    """{subcommand: {flag: (default, type, nargs, required, action)}}"""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.option_strings[0]: (a.default, a.type, a.nargs,
                                         a.required, type(a).__name__)
                   for a in p._actions if a.option_strings
                   and a.option_strings[0] != "-h"}
            for name, p in sub.choices.items()}


def test_cli_flags_equal_jax_plus_device(monkeypatch):
    want = _commands(_jax_parser(monkeypatch))
    got = _commands(cli.build_parser())
    assert set(got) == set(want) == {"quantize", "generate", "eval",
                                     "benchmark"}
    for name in want:
        dev = got[name].pop("--device")
        assert dev[0] is None and not dev[3]
        assert got[name] == want[name], name
    args = cli.build_parser().parse_args(
        ["benchmark", "--model", "m", "--contexts", "8", "16"])
    assert (args.fn, args.contexts, args.device) == (cli.cmd_benchmark,
                                                     [8, 16], None)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded 2-layer W4 llama (g32) saved as an AutoAWQ checkpoint, with
    a word-level tokenizer built by ``tokenizers``."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    d = tmp_path_factory.mktemp("tiny")
    cfg = ModelConfig(**LLAMA)
    params = random_quantized_params(cfg, seed=0, group_size=32,
                                     device="cpu")
    serialize.save_quantized(str(d), cfg, AwqConfig(q_group_size=32), params)
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            eos_token="</s>").save_pretrained(str(d))
    return str(d)


def test_generate_runs_on_the_cpu(checkpoint, capsys):
    cli.main(["generate", "--model", checkpoint, "--prompt",
              "the meaning of life is", "--max-new-tokens", "4",
              "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("the meaning of life is")
    # four new words, or fewer ending at the eos (decoded as text)
    assert len(out.split()) == 5 + 4 or out.endswith("</s>")


def test_benchmark_runs_on_the_cpu(checkpoint, capsys):
    cli.main(["benchmark", "--model", checkpoint, "--contexts", "8", "16",
              "--decode", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["bs=1 ctx=8", "bs=1 ctx=16"]
    assert all(float(ln.split()[-2]) > 0 for ln in lines)


def test_module_entry_point_runs_benchmark(checkpoint):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "autoawq_tpu_torch", "benchmark", "--model",
         checkpoint, "--contexts", "8", "--decode", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("bs=1 ctx=8: decode ")


def test_trace_summarizes_a_cpu_forward(tmp_path, capsys):
    cfg = ModelConfig(**LLAMA)
    params = random_quantized_params(cfg, seed=1, group_size=32,
                                     device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (1, 8)))
    with profiling.trace(str(tmp_path), device="cpu") as d:
        for _ in range(2):
            modules.forward(cfg, params, tokens, method="plain",
                            dtype=torch.float32)
    assert d == str(tmp_path)
    rows = profiling.summarize_trace(d, top=None)
    names = [n for n, _, _ in rows]
    assert rows and all(us >= 0 and n >= 1 for _, us, n in rows)
    assert [us for _, us, _ in rows] == sorted((us for _, us, _ in rows),
                                               reverse=True)
    assert any("matmul" in n or "mm" in n for n in names)
    assert len(profiling.summarize_trace(d, top=3)) == 3
    profiling.print_trace_summary(d, top=2)
    assert len(capsys.readouterr().out.strip().splitlines()) == 2
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "none"))


def test_nan_checks_toggle_and_raise():
    cfg = ModelConfig(**LLAMA)
    params = random_quantized_params(cfg, seed=2, group_size=32,
                                     device="cpu")
    params["norm"]["weight"] = torch.full_like(params["norm"]["weight"],
                                               float("nan"))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    try:
        profiling.enable_nan_checks(True)
        assert profiling.NAN_CHECKS and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="NaN in logits"):
            modules.forward(cfg, params, tokens, method="plain")
    finally:
        profiling.enable_nan_checks(False)
    assert not profiling.NAN_CHECKS and not torch.is_anomaly_enabled()
    assert torch.isnan(modules.forward(cfg, params, tokens,
                                       method="plain")).all()
