"""The port's examples (``examples/torch_*.py``) against the JAX package's
(``examples/*.py``), each run in-process: JAX's with ``sys.argv`` patched,
then its twin with ``--device cpu``. One tiny llama (2 layers, hidden 64,
g32) is saved once by the JAX package and loaded by both; its float twin is
a seeded transformers llama; a word-level tokenizer is built with
``tokenizers`` and a local dataset directory holds the calibration and
training text (no download). Then the facades' ``to_device`` in JAX's
chain ``from_quantized(path).to_device()``.

Tolerances:

* ``generate`` and ``serve``: the printed greedy streams equal;
* ``quantize``: the checkpoints' tensors bit-equal where no clip search
  ran (norms, embedding, head, q / k); where it ran, nibbles equal on at
  least 98% and within 2, scales on at least 97%: the bounds of
  ``tests/test_torch_quantizer.py``'s whole quantizer, whose clip grid
  takes another point where a clipped weight lands on a round-half tie
  that the packages' last-bit differences round the other way (1-2% of
  this model's searched entries);
* ``eval --task kldiv``: the report's KL mean within 2e-2 of JAX's plus
  5% of it, the top-k agreements within 1/64 (one position of 64), against
  ``kl_divergence_report`` of the models JAX's example loads (its own call
  binds its arguments otherwise and raises TypeError);
* ``train``: the ``.npz`` keys and shapes equal; the losses of the adapters
  each package trained (2 AdamW steps at lr 1e-2), evaluated on the same
  batch in f32, within 2e-2 of each other (the port trains in bf16, JAX in
  f32), and the first step's printed loss within 2e-2;
* ``benchmark``: the JSON rows' keys and rounds equal;
* ``to_device``: logits of JAX's chain and the port's within 3e-2 of the
  logit scale (bf16 weights on both sides; the port keeps scales f32).
"""

import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(model_type="llama", vocab_size=64, hidden_size=64,
             intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=256)
WORDS = ["<unk>", "</s>", "the", "meaning", "of", "life", "is", "a", "cat",
         "sat", "on", "mat"]
WORDS += [f"w{i}" for i in range(len(WORDS), LLAMA["vocab_size"])]
GROUP = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path):
    """A script of the repository as a module (examples/ and scripts/ are
    no packages)."""
    name = "ex_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO,
                                                                     path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def save_tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            eos_token="</s>").save_pretrained(str(path))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"q": the JAX-written W4 checkpoint, "fp": a seeded transformers
    float llama, "data": a local dataset directory of seeded word text},
    each checkpoint with the word-level tokenizer."""
    import transformers

    from autoawq_tpu.config import AwqConfig as JaxAwqConfig
    from autoawq_tpu.io import serialize as jser
    from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
    from autoawq_tpu.utils.synth import random_quantized_params

    root = tmp_path_factory.mktemp("examples")
    out = {k: str(root / k) for k in ("q", "fp", "data")}
    jcfg = JaxModelConfig(**LLAMA)
    jser.save_quantized(out["q"], jcfg, JaxAwqConfig(q_group_size=GROUP),
                        random_quantized_params(jcfg, seed=0,
                                                group_size=GROUP))
    save_tokenizer(out["q"])

    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=False))
    hf.save_pretrained(out["fp"], safe_serialization=True)
    save_tokenizer(out["fp"])

    os.makedirs(out["data"])
    rng = np.random.default_rng(5)
    with open(os.path.join(out["data"], "train.jsonl"), "w") as f:
        for _ in range(64):
            words = rng.choice(WORDS[2:], int(rng.integers(20, 60)))
            f.write(json.dumps({"text": " ".join(words)}) + "\n")
    return out


@pytest.fixture(scope="module")
def tokenizer(dirs):
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(dirs["q"])


def run_jax(monkeypatch, path, argv):
    """JAX's example ``path`` in-process with ``sys.argv`` patched."""
    mod = load(path)
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [path] + argv)
        return mod.main()


def test_generate_streams_equal_jax(dirs, monkeypatch, capsys):
    argv = ["--model", dirs["q"], "--prompt", "the cat sat on",
            "--max-new-tokens", "8"]
    run_jax(monkeypatch, "examples/generate.py", argv)
    want = capsys.readouterr().out
    out = load("examples/torch_generate.py").main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert out.shape == (1, 4 + 8)
    assert got.startswith("the cat sat on")


def test_serve_streams_equal_jax(dirs, monkeypatch, capsys):
    argv = ["--model", dirs["q"], "--max-batch", "2", "--max-seq-len", "64",
            "--max-new-tokens", "6", "--prompts", "the cat sat",
            "a mat is on the", "life"]
    run_jax(monkeypatch, "examples/serve.py", argv)
    want = capsys.readouterr().out
    eng = load("examples/torch_serve.py").main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert len(eng.finished) == 3

    def finals(text):
        return text[text.index("=== request"):]

    # the per-step lines interleave by slot; the streams themselves equal
    assert sorted(got.splitlines()) == sorted(want.splitlines())
    assert sorted(finals(got).split("=== ")) == sorted(
        finals(want).split("=== "))


def test_quantize_checkpoints_bit_equal_jax(dirs, monkeypatch, tmp_path,
                                            capsys):
    from autoawq_tpu_torch.core.packing import unpack_awq
    from autoawq_tpu_torch.io.safetensors import load_file

    common = ["--model", dirs["fp"], "--calib", dirs["data"],
              "--group-size", str(GROUP), "--max-calib-samples", "16",
              "--max-calib-seq-len", "64"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    run_jax(monkeypatch, "examples/quantize.py", common + ["--out", jout])
    load("examples/torch_quantize.py").main(
        common + ["--out", tout, "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith(
        f"saved AWQ model to {tout}")

    def tensors(d):
        sd = {}
        for f in sorted(os.listdir(d)):
            if f.endswith(".safetensors"):
                sd.update(load_file(os.path.join(d, f)))
        return sd

    want, got = tensors(jout), tensors(tout)
    assert set(got) == set(want)
    assert any(k.endswith(".qweight") for k in got)
    same = tot = scales_same = scales_tot = 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        lin = k.rsplit(".", 1)[0]
        searched = lin.endswith(("mlp.gate_proj", "mlp.up_proj",
                                 "mlp.down_proj", "v_proj", "o_proj"))
        if not searched:  # no clip search: bit-equal
            assert torch.equal(got[k], want[k]), k
        elif k.endswith(".qweight"):
            qa, qb = (unpack_awq(t[k].numpy()) for t in (got, want))
            assert np.abs(qa.astype(int) - qb).max() <= 2, k
            same += int((qa == qb).sum())
            tot += qa.size
        elif k.endswith(".scales"):
            scales_same += int((got[k] == want[k]).sum())
            scales_tot += got[k].numel()
    print(f"clip-searched linears: nibbles equal {same}/{tot}, scales "
          f"equal {scales_same}/{scales_tot}")
    assert same >= 0.98 * tot and scales_same >= 0.97 * scales_tot
    assert os.path.isfile(os.path.join(tout, "tokenizer.json"))


def test_eval_kldiv_within_tolerance_of_jax(dirs, monkeypatch, capsys):
    from autoawq_tpu import api as japi
    from autoawq_tpu.eval.perplexity import kl_divergence_report

    argv = ["--model", dirs["q"], "--task", "kldiv", "--ref", dirs["fp"],
            "--n", "2"]
    # JAX's example passes (cfg, ref params, test params, tokens) to a
    # function of (cfg_ref, params_ref, cfg_test, params_test, tokens)
    with pytest.raises(TypeError):
        run_jax(monkeypatch, "examples/eval.py", argv)
    capsys.readouterr()
    jq = japi.AutoAWQForCausalLM.from_quantized(dirs["q"]).to_device()
    jr = japi.AutoAWQForCausalLM.from_pretrained(dirs["fp"]).to_device()
    tokens = np.random.default_rng(0).integers(0, 64, (2, 256))
    want = kl_divergence_report(jr.cfg, jr.params, jq.cfg, jq.params, tokens)

    got = load("examples/torch_eval.py").main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == got
    assert got["task"] == "kldiv"
    assert set(got) == {"task"} | set(want)
    assert abs(got["kl_mean"] - want["kl_mean"]) <= 2e-2 + 0.05 * want[
        "kl_mean"]
    for k in want:
        if re.fullmatch(r"(ref|test)_top\d+", k):
            assert abs(got[k] - float(want[k])) <= 1 / 64 + 1e-9, k


def test_train_adapters_and_losses_match_jax(dirs, monkeypatch, tmp_path,
                                             capsys):
    from autoawq_tpu_torch.api import AwqCausalLM
    from autoawq_tpu_torch.train import lora as lora_mod

    common = ["--model", dirs["q"], "--dataset", dirs["data"], "--steps",
              "2", "--batch-size", "2", "--seq-len", "32", "--lr", "1e-2"]
    jnpz, tnpz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    run_jax(monkeypatch, "examples/train.py", common + ["--out", jnpz])
    jlog = capsys.readouterr().out
    losses = load("examples/torch_train.py").main(
        common + ["--out", tnpz, "--device", "cpu"])
    tlog = capsys.readouterr().out
    assert len(losses) == 2
    first = [float(re.search(r"step\s+0\s+loss (\S+)", s).group(1))
             for s in (jlog, tlog)]
    assert abs(first[0] - first[1]) <= 2e-2
    assert tlog.strip().endswith(f"adapter tensors to {tnpz}")

    ja, ta = np.load(jnpz), np.load(tnpz)
    assert sorted(ja.files) == sorted(ta.files)
    assert "layers.0.self_attn.q_proj.lora_a" in ta.files
    for k in ja.files:
        assert ja[k].shape == ta[k].shape and ta[k].dtype == np.float32, k

    # each package's trained adapters on the same base and batch, in f32
    model = AwqCausalLM.from_quantized(dirs["q"], device="cpu",
                                       dtype=torch.float32)
    batch = torch.from_numpy(np.random.default_rng(9).integers(
        2, 64, (2, 32)))

    def loss_with(npz):
        lora_mod.add_lora(model.cfg, model.params, rank=8)
        for lp_i, lp in enumerate(model.params["layers"]):
            for name, p in lp["self_attn"].items():
                for leaf in ("lora_a", "lora_b"):
                    key = f"layers.{lp_i}.self_attn.{name}.{leaf}"
                    if key in npz.files:
                        p[leaf] = torch.from_numpy(npz[key])
        return float(lora_mod.causal_lm_loss(model.cfg, model.params, batch,
                                             method="plain"))

    lj, lt = loss_with(ja), loss_with(ta)
    assert abs(lj - lt) <= 2e-2, (lj, lt)


def test_benchmark_rows_have_jax_keys(dirs, monkeypatch, capsys):
    argv = ["--model", dirs["q"], "--rounds", "1"]
    run_jax(monkeypatch, "examples/benchmark.py", argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = load("examples/torch_benchmark.py").main(argv + ["--device",
                                                            "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == json.dumps(rows)
    assert lines[0] == ("| batch | ctx | gen | prefill tok/s | decode "
                        "tok/s | mem (GB) |")
    assert [sorted(r) for r in rows] == [sorted(r) for r in want]
    assert [(r["batch"], r["ctx"], r["gen"]) for r in rows] == [
        (r["batch"], r["ctx"], r["gen"]) for r in want]
    assert all(r["decode_tok_s"] > 0 for r in rows)


def test_server_answers_as_jax_does(dirs, monkeypatch, tokenizer, capsys):
    """Each package's example serves one completion through its own
    ``serve_http`` stand-in (the server started, one request, stopped)."""
    import urllib.request

    import autoawq_tpu.serve.server as jserver
    from autoawq_tpu_torch.serve import server as tserver

    answers = []

    def one_request(start):
        def serve(engine, tok, host, port, model_name, burst):
            es, httpd = start(engine, tok, host, 0, model_name, burst=burst)
            try:
                body = json.dumps({"prompt": "the cat sat",
                                   "max_tokens": 5}).encode()
                req = urllib.request.Request(
                    f"http://127.0.0.1:{httpd.server_address[1]}"
                    "/v1/completions", data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    answers.append(json.loads(r.read()))
                    return answers[-1]
            finally:
                httpd.shutdown()
                es.shutdown()
        return serve

    argv = ["--model", dirs["q"], "--paged", "--page-size", "16",
            "--total-pages", "16", "--max-seq-len", "64", "--max-batch", "2"]
    got = load("examples/torch_server.py").main(
        argv + ["--device", "cpu"], serve=one_request(tserver.start_server))
    with monkeypatch.context() as m:
        m.setattr(jserver, "serve_http", one_request(jserver.start_server))
        run_jax(monkeypatch, "examples/server.py", argv)
    want = answers[-1]
    assert capsys.readouterr().out.count("(paged engine)") == 2
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]


def test_to_device_chain_within_bf16_of_jax(dirs):
    """JAX's examples' chain ``from_quantized(path).to_device()`` on the
    port: it returns the model, casts the float leaves to bf16 on the
    model's device and keeps the scales f32 (the kernels' contract, where
    JAX casts them too)."""
    from autoawq_tpu import api as japi
    from autoawq_tpu_torch import AutoAWQForCausalLM, AwqCausalLM

    ids = np.random.default_rng(3).integers(0, 64, (1, 12))
    jm = japi.AutoAWQForCausalLM.from_quantized(dirs["q"]).to_device()
    want = np.asarray(jm(ids), dtype=np.float32)

    m = AutoAWQForCausalLM.from_quantized(dirs["q"], device="cpu",
                                          dtype=torch.float32)
    assert m.params["embed_tokens"]["weight"].dtype == torch.float32
    assert m.to_device() is m
    assert isinstance(m, AwqCausalLM)
    q = m.params["layers"][0]["self_attn"]["q_proj"]
    assert m.params["embed_tokens"]["weight"].dtype == torch.bfloat16
    assert q["scales"].dtype == torch.float32
    assert q["qweight"].dtype == torch.int32
    assert q["qweight"].device.type == "cpu"
    got = m(ids).float().numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    assert m.to_device(torch.float32).params["embed_tokens"][
        "weight"].dtype == torch.float32
