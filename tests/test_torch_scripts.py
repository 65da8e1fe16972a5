"""The port's scripts (``scripts/torch_*.py``) against the JAX package's
(``scripts/*.py``) on the CPU, and the rules that no new example or script
imports ``jax`` or the JAX package, and no port of one imports
``chip_smoke.py``.

* ``bench_table``: the reference rows (``BASELINES``, ``MODELS``, ``RUNS``)
  and the byte and operation counters equal JAX's exactly, row for row;
* ``quality``: the synthetic mode's report has JAX's keys (JAX's
  ``_report`` on JAX's variants of the same float weights); AWQ's chosen
  scale-grid index equals JAX's for every group and the clip search equals
  JAX's on JAX's own inputs (``tests/test_torch_quantizer.py``'s
  recording quantizer), on the synthetic recipe's float weights carried
  across (equal draws) at a narrow width; the trained mode's corpus and
  recipe are JAX's;
* ``make_artifact``: ``RECIPE`` and ``CFG_KW`` equal; the float model from
  the recipe equals JAX's at a narrow width; its float checkpoint reloads
  in JAX;
* ``kbench``, ``bench_serve`` (JAX's tiny mode) and ``bench_quant_time``
  (a narrow width, one layer): each runs on the CPU and writes its JSON.
"""

import ast
import glob
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = sorted(glob.glob(os.path.join(REPO, "examples", "torch_*.py"))
             + glob.glob(os.path.join(REPO, "scripts", "torch_*.py")))
PORTED = ("benchmark", "eval", "generate", "quantize", "serve", "server",
          "train", "quality", "make_artifact", "kbench", "bench_table",
          "bench_serve", "bench_quant_time")
NARROW = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(path):
    name = "sc_" + os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO,
                                                                     path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_example_and_script_has_a_port():
    names = {os.path.basename(p)[len("torch_"):-3] for p in NEW}
    assert set(PORTED) <= names


def test_new_files_import_neither_jax_nor_the_jax_package():
    for path in NEW:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "autoawq_tpu",
                                   "ml_dtypes"), (path, m)
    code = ("import importlib.util, sys\n"
            f"for p in {NEW!r}:\n"
            "    s = importlib.util.spec_from_file_location('m', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'autoawq_tpu', 'transformers', 'datasets')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_ported_examples_and_scripts_do_not_import_chip_smoke():
    for name in PORTED:
        path = next(p for p in NEW
                    if os.path.basename(p) == f"torch_{name}.py")
        for node in ast.walk(ast.parse(open(path).read())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            assert "chip_smoke" not in mods, path


def test_bench_table_counters_equal_jax():
    from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
    from autoawq_tpu_torch.models.config import ModelConfig

    j, t = load("scripts/bench_table.py"), load("scripts/torch_bench_table.py")
    assert t.BASELINES == j.BASELINES
    assert t.MODELS == j.MODELS
    assert t.RUNS == j.RUNS
    limit = 80 * 10 ** 9
    for name, b, ctx, dec, kv in t.RUNS:
        knobs = {"model_type": "llama", **t.MODELS[name]}
        gsz = knobs.pop("_group_size", 128)
        jc = JaxModelConfig(max_position_embeddings=8192, **knobs)
        tc = ModelConfig(max_position_embeddings=8192, **knobs)
        cap = ctx + dec
        assert t.weight_stream_bytes(tc, gsz) == j.weight_stream_bytes(jc,
                                                                       gsz)
        assert t.weight_resident_bytes(tc, gsz) == \
            j.weight_resident_bytes(jc, gsz)
        assert t.cache_stream_bytes(tc, b, cap, kv) == \
            j.cache_stream_bytes(jc, b, cap, kv)
        assert t.flops_per_token(tc) == j.flops_per_token(jc)
        for lim in (limit, 16 * 10 ** 9):
            assert t.fits(tc, b, cap, kv, lim, gsz) == \
                j.fits(jc, b, cap, kv, lim, gsz)


@pytest.fixture(scope="module")
def quality(monkeypatch_module):
    """The port's quality script at a narrow synthetic width."""
    q = load("scripts/torch_quality.py")
    monkeypatch_module.setattr(q, "SYNTH_CFG", dict(model_type="llama",
                                                    **NARROW))
    monkeypatch_module.setattr(q, "SEQ", 32)
    monkeypatch_module.setattr(q, "N_EVAL_TOKENS", 256)
    monkeypatch_module.setattr(q, "N_CALIB", 4)
    return q


@pytest.fixture(scope="module")
def monkeypatch_module():
    m = pytest.MonkeyPatch()
    yield m
    m.undo()


def _jax_synthetic():
    """JAX's synthetic recipe (``scripts/quality.py::run_synthetic``'s
    draws) at the narrow width."""
    from autoawq_tpu.io.hf import init_random_params
    from autoawq_tpu.models.config import ModelConfig as JaxModelConfig

    cfg = JaxModelConfig(model_type="llama", max_position_embeddings=33,
                         **NARROW)
    params = init_random_params(cfg, seed=7, scale=0.08)
    params["embed_tokens"]["weight"][:, :16] *= 20.0
    return cfg, params


def _uniform(params):
    """The tree with a zero head: uniform next-token odds (its perplexity
    is the vocabulary size, above any model's on its own samples)."""
    out = dict(params)
    out["lm_head"] = {"kernel": params["lm_head"]["kernel"] * 0}
    return out


def test_quality_report_has_jax_keys(quality, tmp_path, monkeypatch):
    """Each package's ``_report`` on the same narrow float model, on
    streams it sampled itself: fp32, "awq" the float model (Δppl 0) and
    "rtn" its uniform twin (Δppl > 0), so the gate's ordering holds by
    construction and the report's keys are compared. At this width the
    synthetic mode's own gate does not hold (AWQ's Δppl above RTN's at 2 x
    128 on 4 x 32 calibration ids, AWQ's KL below RTN's), so the mode runs
    end to end at its own width only."""
    import jax.numpy as jnp

    out = str(tmp_path / "q.json")
    cfg, params = quality.synthetic_model("cpu")
    sampled = quality._sample(cfg, params, 10, 11)
    got = quality._report(cfg, params, {
        "fp32": params, "rtn_w4g128": _uniform(params),
        "awq_w4g128": params}, sampled[2:].reshape(-1), sampled[:2],
        {"model": "narrow", "w_bit": 4, "q_group_size": 128}, out)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(got))

    j = load("scripts/quality.py")
    monkeypatch.setattr(j, "SEQ", 32)
    monkeypatch.chdir(tmp_path)  # JAX's _report writes QUALITY.json here
    jcfg, jparams = _jax_synthetic()
    js = j._sample(jcfg, jparams, 10, 11)
    want = j._report(jcfg, jparams, {
        "fp32": jparams, "rtn_w4g128": {
            **jparams, "lm_head": {"kernel": jnp.zeros_like(
                jparams["lm_head"]["kernel"])}},
        "awq_w4g128": jparams}, js[2:].reshape(-1), js[:2],
        {"model": "narrow", "w_bit": 4, "q_group_size": 128})
    assert {k: sorted(v) if isinstance(v, dict) else None
            for k, v in got.items()} == {
        k: sorted(v) if isinstance(v, dict) else None
        for k, v in want.items()}
    assert got["awq_w4g128"]["delta_ppl"] == 0
    assert got["config"]["eval_tokens"] == want["config"]["eval_tokens"]


def test_quality_awq_choices_equal_jax(quality):
    from autoawq_tpu.config import AwqConfig as JaxAwqConfig
    from test_torch_quantizer import RecordingJaxQuantizer

    jcfg, jparams = _jax_synthetic()
    cfg, params = quality.synthetic_model("cpu")
    for a, b in zip(jax_leaves(jparams), torch_leaves(params)):
        np.testing.assert_array_equal(b.numpy(), a)
    calib = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    jq = RecordingJaxQuantizer(jcfg, JaxAwqConfig(), jparams, calib,
                               progress=False)
    jq.quantize()
    tq, tout = quality._awq(cfg, params, calib, torch.device("cpu"))
    assert "qweight" in tout["layers"][0]["mlp"]["down_proj"]
    choices = [c["best"] for layer in tq.scale_choices for c in layer]
    assert choices == [int(np.nanargmin(x)) for x in jq.losses]
    assert jq.clip_calls
    for w, inp, ref in jq.clip_calls:
        got = tq._search_best_clip(torch.from_numpy(w), torch.from_numpy(inp))
        np.testing.assert_array_equal(got.numpy(), ref)
    # the float tree is left as it is
    assert "kernel" in params["layers"][0]["mlp"]["down_proj"]


def jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def torch_leaves(tree):
    """The tensors in ``jax_leaves``' order (sorted keys)."""
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_quality_trained_recipe_is_jax_s(quality):
    from autoawq_tpu.train import pretrain as jpre
    from autoawq_tpu_torch.train import pretrain

    src = open(os.path.join(REPO, "scripts", "quality.py")).read()
    for knob in ("vocab_size=vocab, hidden_size=256",
                 "intermediate_size=1024, num_hidden_layers=4, "
                 "num_attention_heads=8",
                 "num_key_value_heads=4, head_dim=32", "steps=steps, "
                 "batch=16", "seq=64", "420_000", "400_000",
                 '"AWQ_TPU_QUALITY_STEPS", "300"', "fp_ppl < 100",
                 "d_awq <= 0.10 * fp_ppl"):
        assert knob in src, knob
    assert quality.TRAINED_CFG == dict(
        model_type="llama", vocab_size=512, hidden_size=256,
        intermediate_size=1024, num_hidden_layers=4, num_attention_heads=8,
        num_key_value_heads=4, head_dim=32)
    assert quality.TRAIN_STEPS == 300
    np.testing.assert_array_equal(pretrain.synth_corpus(512, 5000, seed=0),
                                  jpre.synth_corpus(512, 5000, seed=0))


def test_make_artifact_recipe_and_fp_model_equal_jax(monkeypatch,
                                                     tmp_path):
    from autoawq_tpu.io import serialize as jser

    j = load("scripts/make_artifact.py")
    t = load("scripts/torch_make_artifact.py")
    assert t.RECIPE == j.RECIPE and t.CFG_KW == j.CFG_KW
    assert t.ARTIFACT_DIR != j.ARTIFACT_DIR
    narrow = dict(j.CFG_KW, **NARROW)
    monkeypatch.setattr(j, "CFG_KW", narrow)
    monkeypatch.setattr(t, "CFG_KW", narrow)
    jcfg, jp = j.fp_model_from_recipe()
    cfg, tp = t.fp_model_from_recipe("cpu")
    assert jp["embed_tokens"]["weight"][0, 0] != 0
    for a, b in zip(jax_leaves(jp), torch_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a)
    path = str(tmp_path / "fp")
    t.save_fp_checkpoint(path, cfg, tp)
    _, back = jser.from_pretrained(path)
    np.testing.assert_array_equal(
        np.asarray(back["layers"][1]["mlp"]["down_proj"]["kernel"]),
        tp["layers"][1]["mlp"]["down_proj"]["kernel"].half().float().numpy())


def test_kbench_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    j, t = load("scripts/kbench.py"), load("scripts/torch_kbench.py")
    assert t.SHAPES == j.SHAPES
    monkeypatch.setattr(t, "SHAPES", [(256, 128, "qkv"), (512, 64, "down")])
    monkeypatch.setattr(t, "ITERS", 2)
    out = str(tmp_path / "k.json")
    rows = t.main(["1", "256", "--device", "cpu", "--out", out])
    assert [(r["M"], r["tag"], r["kernel"]) for r in rows] == [
        (1, "qkv", "w4a16_gemv"), (1, "down", "w4a16_gemv"),
        (256, "qkv", "w4a16_gemm"), (256, "down", "w4a16_gemm")]
    assert all(r["us"] > 0 for r in rows)
    with open(out) as f:
        assert json.load(f)["rows"] == rows
    assert "total one-layer+lm sweep" in capsys.readouterr().out


def test_bench_serve_tiny_mode_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("AWQ_TPU_BENCH_TINY", "1")
    t = load("scripts/torch_bench_serve.py")
    assert t.TINY and (t.N_CLIENTS, t.PROMPT_LEN, t.MAX_TOKENS,
                       t.MAX_BATCH) == (4, 16, 16, 2)
    out = str(tmp_path / "s.json")
    got = t.main(["--device", "cpu", "--out", out])
    assert [(r["engine"], r["burst"]) for r in got["runs"]] == [
        ("slot", 1), ("slot", 16), ("paged", 1), ("paged", 16)]
    for r in got["runs"]:
        assert r["tokens_streamed"] == 4 * 16
        assert r["ttft_p50_s"] > 0 and r["throughput_tok_s"] > 0
    assert got["runs"][3]["prefix_hits"] >= 3
    with open(out) as f:
        assert json.load(f)["dispatch_floor_ms"] == got["dispatch_floor_ms"]


def test_bench_quant_time_narrow_on_the_cpu(tmp_path, monkeypatch):
    t = load("scripts/torch_bench_quant_time.py")
    assert t.CALIB == (128, 512) and t.MODEL["hidden_size"] == 4096
    monkeypatch.setattr(t, "CALIB", (4, 32))
    monkeypatch.setattr(t, "MODEL", dict(
        t.MODEL, vocab_size=256, hidden_size=128, intermediate_size=256,
        num_attention_heads=4, num_key_value_heads=2, head_dim=32))
    out = str(tmp_path / "t.json")
    got = t.main(["--layers", "1", "--device", "cpu", "--out", out])
    assert got["seconds"] > 0 and got["model_shape"].startswith(
        "mistral-7b (1L, h128")
    with open(out) as f:
        assert json.load(f)["seconds"] == got["seconds"]


def test_quality_artifact_mode_refuses_without_its_artifact(tmp_path):
    q = load("scripts/torch_quality.py")
    with pytest.raises(SystemExit):
        q.main(["--mode", "artifact", "--artifact", str(tmp_path),
                "--device", "cpu", "--out", str(tmp_path / "q.json")])
    assert not (tmp_path / "q.json").exists()


def test_quality_artifact_mode_on_a_narrow_artifact(quality, monkeypatch,
                                                    tmp_path):
    """``make_artifact`` at the narrow width on the CPU, then ``quality
    --mode artifact`` on its checkpoint: the report's variants and Δppl
    keys, with AWQ's Δppl below RTN's (the gate ``_report`` asserts)."""
    ma = sys.modules["torch_make_artifact"]
    monkeypatch.setattr(ma, "CFG_KW", dict(ma.CFG_KW, **NARROW))
    monkeypatch.setattr(ma, "RECIPE", dict(ma.RECIPE, n_calib=4,
                                           calib_seq=32))
    q_dir, out = str(tmp_path / "awq"), str(tmp_path / "q.json")
    ma.main(["--out", q_dir, "--device", "cpu"])
    rep = quality.main(["--mode", "artifact", "--artifact", q_dir,
                        "--device", "cpu", "--out", out])
    assert set(rep) >= {"config", "fp32", "rtn_w4g128", "awq_w4g128"}
    assert rep["config"]["eval_tokens"] == quality.N_EVAL_TOKENS
    assert rep["awq_w4g128"]["delta_ppl"] < rep["rtn_w4g128"]["delta_ppl"]
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(rep))


def test_device_kernels_times_the_call_alone_on_the_cpu():
    from autoawq_tpu_torch.utils.profiling import device_kernels

    out, wall, kernels = device_kernels(lambda: torch.ones(3).sum(), "cpu")
    assert float(out) == 3.0 and wall >= 0 and kernels == {}


def test_synth_zoo_params_draws_a_runnable_seeded_model():
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.modules import forward
    from autoawq_tpu_torch.utils.synth import synth_zoo_params

    cfg = ModelConfig(model_type="llama", max_position_embeddings=64,
                      **NARROW)
    a, b = (synth_zoo_params(cfg, 3, "cpu") for _ in range(2))
    for x, y in zip(torch_leaves(a), torch_leaves(b)):
        assert torch.equal(x, y)
    lp = a["layers"][0]
    assert set(lp["self_attn"]) == {"qkv_proj", "o_proj"}
    assert set(lp["mlp"]) == {"gate_up_proj", "down_proj"}
    assert lp["mlp"]["gate_up_proj"]["scales"].shape == (1, 2 * 256)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 8)))
    logits = forward(cfg, a, tokens, method="plain", dtype=torch.float32)
    assert logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(logits).all()
