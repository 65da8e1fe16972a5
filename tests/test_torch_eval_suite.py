"""The port's evaluation suite (``autoawq_tpu_torch/eval``: ``tasks``,
``humaneval``, ``lm_eval_adapter``) against the JAX package's on the same
seeded models (``init_random_params``: both packages draw the same
weights from one seed) and inputs. Tolerances: f32 log-likelihoods within
1e-5 relative (summation order only); accuracy, WER, pass@k, the stop
rule and the sandbox's verdicts exactly."""

import numpy as np
import pytest
import torch

from autoawq_tpu.eval import humaneval as jhe
from autoawq_tpu.eval import lm_eval_adapter as jla
from autoawq_tpu.eval import tasks as jtasks
from autoawq_tpu.io.hf import init_random_params as jax_init
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu_torch.eval import humaneval as he
from autoawq_tpu_torch.eval import lm_eval_adapter as la
from autoawq_tpu_torch.eval import tasks
from autoawq_tpu_torch.io.hf import init_random_params
from autoawq_tpu_torch.models.config import ModelConfig

PROBLEM = {
    "task_id": "t/0",
    "prompt": "def add(a, b):\n",
    "test": "def check(f):\n    assert f(1, 2) == 3\n    assert f(-1, 1) == 0\n",
    "entry_point": "add",
}
LLAMA = dict(model_type="llama", vocab_size=97, hidden_size=32,
             intermediate_size=64, num_hidden_layers=2,
             num_attention_heads=2, num_key_value_heads=2, head_dim=16,
             max_position_embeddings=256)


class CharTok:
    """A character-level stub tokenizer (ids below 97), no download."""
    eos_token_id = 0

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": self.encode(text)}

    def encode(self, text):
        return [ord(c) % 97 for c in text]

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


def _models(seed=0, scale=0.3, **over):
    d = dict(LLAMA, **over)
    jcfg, cfg = JaxModelConfig(**d), ModelConfig(**d)
    return (jcfg, jax_init(jcfg, seed=seed, scale=scale), cfg,
            init_random_params(cfg, seed=seed, scale=scale, device="cpu"))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("pad_to", [None, 12])
def test_choice_loglikelihood_equals_jax(pad_to):
    jcfg, jp, cfg, p = _models()
    got = tasks.choice_loglikelihood(cfg, p, [1, 2, 3, 9], [4, 5, 6],
                                     pad_to=pad_to, method="plain")
    want = jtasks.choice_loglikelihood(jcfg, jp, [1, 2, 3, 9], [4, 5, 6],
                                       pad_to=pad_to, method="jnp")
    assert np.isfinite(got) and _rel(got, want) < 1e-5


def test_eval_multiple_choice_equals_jax():
    jcfg, jp, cfg, p = _models(seed=1)
    rng = np.random.default_rng(5)
    words = ["red", "green", "blue", "cyan", "plum", "gold", "jade", "teal"]
    exs = [{"question": f"pick {i}?",
            "choices": list(rng.choice(words, 4, replace=False)),
            "answer": int(rng.integers(0, 4))} for i in range(4)]
    got = tasks.eval_multiple_choice(cfg, p, CharTok(), exs, subject="x_y",
                                     method="plain")
    want = jtasks.eval_multiple_choice(jcfg, jp, CharTok(), exs,
                                       subject="x_y", method="jnp")
    assert got == want and got["n"] == 4
    # and the scores behind each pick
    tok = CharTok()
    for ex in exs:
        prompt = tasks.format_mmlu_prompt(ex["question"], ex["choices"], "x_y")
        assert prompt == jtasks.format_mmlu_prompt(ex["question"],
                                                   ex["choices"], "x_y")
        ctx = tok(prompt)["input_ids"]
        for letter in tasks.MMLU_CHOICES:
            cont = tok(" " + letter)["input_ids"]
            a = tasks.choice_loglikelihood(cfg, p, ctx, cont, method="plain")
            b = jtasks.choice_loglikelihood(jcfg, jp, ctx, cont, method="jnp")
            assert _rel(a, b) < 1e-5


def test_word_error_rate_equals_jax():
    cases = [(["a b c"], ["a b c"]), (["a b c"], ["a x c"]),
             (["a b"], ["a b c"]), (["the cat sat", "on a mat"],
                                    ["the bat sat down", "a mat"]),
             ([""], ["x"])]
    for refs, hyps in cases:
        assert tasks.word_error_rate(refs, hyps) == \
            jtasks.word_error_rate(refs, hyps)
    assert tasks.word_error_rate(["a b c"], ["a x c"]) == pytest.approx(1 / 3)


def test_pass_at_k_and_stop_rule_equal_jax():
    for n, c, k in ((5, [2], 1), (3, [3], 2), ([10, 4], [3, 0], 2),
                    (20, [5, 19, 0], 10)):
        np.testing.assert_array_equal(he.estimate_pass_at_k(n, c, k),
                                      jhe.estimate_pass_at_k(n, c, k))
    for text in ("    return a + b\nprint('x')", "x\ndef f():\n  pass",
                 "y\n#c\nclass A: pass", "no stop", "z\n```\nif 1:"):
        assert he.stop_at_stop_token(text) == jhe.stop_at_stop_token(text)


def test_sandbox_passes_fails_and_times_out():
    assert he.check_correctness(PROBLEM, "    return a + b\n",
                                timeout=5)["passed"]
    r = he.check_correctness(PROBLEM, "    return a - b\n", timeout=5)
    assert not r["passed"] and r["result"].startswith("failed")
    r = he.check_correctness(PROBLEM, "    while True: pass\n", timeout=2)
    assert r["result"] == "timed out"


def test_sandbox_blocks_os_system():
    evil = "    import os; os.system('echo pwned'); return a + b\n"
    r = he.check_correctness(PROBLEM, evil, timeout=5)
    assert not r["passed"] and "disabled by sandbox" in r["result"]
    assert he._GUARD == jhe._GUARD


def test_eval_humaneval_end_to_end(tmp_path):
    def gen(prompt):
        return "    return a + b\nprint('trailing')"  # the stop rule trims

    out = tmp_path / "results.jsonl"
    m = he.eval_humaneval(gen, [PROBLEM], n_samples_per_task=2, ks=(1, 2),
                          out_path=str(out))
    assert m == {"pass@1": 1.0, "pass@2": 1.0}
    assert len(out.read_text().splitlines()) == 2


def test_lm_eval_adapter_equals_jax_without_lm_eval():
    from types import SimpleNamespace

    jcfg, jp, cfg, p = _models(seed=2, scale=0.1, vocab_size=64,
                               hidden_size=64, intermediate_size=128,
                               num_hidden_layers=1, head_dim=32)
    lm = la.AwqTorchLM.__new__(la.AwqTorchLM)  # LM.__init__ needs lm-eval
    lm.model, lm.max_length, lm.method = SimpleNamespace(cfg=cfg, params=p), \
        64, "plain"
    lm.tokenizer = CharTok()
    jlm = jla.AwqTpuLM.__new__(jla.AwqTpuLM)
    jlm.model, jlm.max_length, jlm.method = SimpleNamespace(
        cfg=jcfg, params=jp), 64, "jnp"
    jlm.tokenizer = CharTok()
    for ctx, cont in (([1, 2, 3], [4, 5]), ([7], [8, 9, 10, 11])):
        ll, greedy = lm._loglikelihood_tokens(ctx, cont)
        jll, jgreedy = jlm._loglikelihood_tokens(ctx, cont)
        assert _rel(ll, jll) < 1e-5 and greedy == jgreedy
    req = SimpleNamespace(args=("abc", "de"))
    (ll, _), = lm.loglikelihood([req])
    (jll, _), = jlm.loglikelihood([req])
    assert _rel(ll, jll) < 1e-5
    rolled = lm.loglikelihood_rolling([SimpleNamespace(args=("hello",))])
    jrolled = jlm.loglikelihood_rolling([SimpleNamespace(args=("hello",))])
    assert _rel(rolled[0], jrolled[0]) < 1e-5
    assert lm._encode_pair("ab", "cd") == jlm._encode_pair("ab", "cd")
    out = lm.generate_until([SimpleNamespace(
        args=("abc", {"until": ["q"], "max_gen_toks": 4}))])
    assert len(out) == 1 and isinstance(out[0], str)
    assert la.HAVE_LM_EVAL == jla.HAVE_LM_EVAL
    if not la.HAVE_LM_EVAL:
        with pytest.raises(ImportError, match="lm-eval"):
            la.AwqTorchLM(lm.model, None)
