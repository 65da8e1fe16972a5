"""The port's save path and float loader across packages: a port-saved
AutoAWQ GEMM checkpoint loads in the JAX package's ``from_quantized`` with
the port's logits (f32, within 1e-4 of the logit scale: summation order
only), the two packages' ``state_dict_from_params`` give equal tensors key
for key (no tolerance), ``quantization_config`` is equal, and a float
checkpoint loads into equal trees in both. Plus the facade's quantize ->
save -> load round trip, size shards, auxiliary files, and the card as the
default device."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import hf as jhf
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.quantize import quantizer as jquantizer
from autoawq_tpu.utils.tree import iter_linears as jax_iter_linears
from autoawq_tpu.utils.tree import set_by_path as jax_set_by_path
from autoawq_tpu_torch import AutoAWQForCausalLM, AwqCausalLM
from autoawq_tpu_torch.api import cast_params
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.io import hf, serialize
from autoawq_tpu_torch.io.safetensors import load_file
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.utils.synth import random_quantized_params
from autoawq_tpu_torch.utils.tree import get_by_path, iter_linears

LLAMA = dict(model_type="llama", vocab_size=256, hidden_size=128,
             intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             max_position_embeddings=64)
MIXTRAL = dict(model_type="mixtral", vocab_size=128, hidden_size=64,
               intermediate_size=128, num_hidden_layers=1,
               num_attention_heads=4, num_key_value_heads=4, head_dim=16,
               num_experts=4, num_experts_per_tok=2,
               max_position_embeddings=64)
MODELS = {"llama": LLAMA, "mixtral": MIXTRAL}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The quantizer loops over many small torch ops; with one intra-op
    thread they do not spin against the other test workers' threads (the
    suite runs six workers on a few cores). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_rtn(d, zero_point=True, gs=32, seed=0):
    """The JAX package's round-to-nearest tree of its seeded float weights
    (the router stays float, as AutoAWQ leaves it)."""
    jcfg = JaxModelConfig(**d)
    params = jhf.init_random_params(jcfg, seed=seed)
    qcfg = JaxAwqConfig(q_group_size=gs, zero_point=zero_point)
    for lp in params["layers"]:
        for path, p in list(jax_iter_linears(lp)):
            if path != "mlp.gate":
                jax_set_by_path(lp, path, jquantizer.quantize_linear_params(
                    {k: jnp.asarray(v) for k, v in p.items()}, qcfg))
    return jcfg, qcfg, jax.tree_util.tree_map(np.asarray, params)


def f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(np.float32)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


@pytest.mark.parametrize("name,zero_point", [("llama", True),
                                             ("llama", False),
                                             ("mixtral", True)])
def test_state_dict_equals_jax(name, zero_point):
    d = MODELS[name]
    jcfg, _, jparams = jax_rtn(d, zero_point)
    ref = jhf.state_dict_from_params(jcfg, jparams,
                                     jhf.role_out_features(jcfg))
    cfg = ModelConfig(**d)
    got = hf.state_dict_from_params(cfg, from_jax_params(cfg, jparams),
                                    hf.role_out_features(cfg))
    assert set(got) == set(ref)
    for key, v in got.items():
        r = np.asarray(ref[key])
        assert v.numpy().dtype == r.dtype, key
        np.testing.assert_array_equal(v.numpy(), r, err_msg=key)


def test_role_maps_equal_jax():
    for d in MODELS.values():
        jcfg, cfg = JaxModelConfig(**d), ModelConfig(**d)
        for ours, theirs in ((hf.role_out_features(cfg),
                              jhf.role_out_features(jcfg)),
                             (hf.role_in_features(cfg),
                              jhf.role_in_features(jcfg))):
            # the port's keys are JAX's llama and Mixtral subset, plus the
            # stacked experts' fused gate_up (JAX's has no such role)
            ours.pop("mlp.experts.gate_up_proj", None)
            assert {k: theirs[k] for k in ours} == ours


def port_quantized(d, seed=0):
    cfg = ModelConfig(**d)
    params = hf.init_random_params(cfg, seed=seed, device="cpu")
    params["embed_tokens"]["weight"][:, :6] *= 8.0
    model = AwqCausalLM(cfg, params, device="cpu")
    calib = np.random.default_rng(seed).integers(0, d["vocab_size"], (4, 32))
    model.quantize(calib_data=calib, quant_config={"q_group_size": 32},
                   progress=False)
    return model


@pytest.mark.parametrize("name", list(MODELS))
def test_port_saved_checkpoint_loads_in_jax(tmp_path, rng, name):
    d = MODELS[name]
    model = port_quantized(d)
    model.save_quantized(str(tmp_path))
    jcfg, jqcfg, jparams = jser.from_quantized(str(tmp_path))
    assert jqcfg.to_transformers_dict() == model.quant_config \
        .to_transformers_dict()
    toks = rng.integers(0, d["vocab_size"], (2, 12))
    ref = np.asarray(jm.forward(jcfg, jax.tree_util.tree_map(
        jnp.asarray, f32(jparams)), jnp.asarray(toks), method="jnp",
        dtype=jnp.float32))
    _, _, params = serialize.from_quantized(str(tmp_path), device="cpu")
    got = modules.forward(model.cfg, cast_params(params, torch.float32),
                          torch.from_numpy(toks), method="plain")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_saved_nibbles_equal_the_quantized_model(tmp_path, name):
    """What the facade quantized is what it wrote: nibbles and zeros bit
    for bit, scales rounded to fp16 (the format's type)."""
    model = port_quantized(MODELS[name], seed=1)
    model.save_quantized(str(tmp_path))
    _, _, loaded = serialize.from_quantized(str(tmp_path), device="cpu")
    n = 0
    for lp, lq in zip(model.params["layers"], loaded["layers"]):
        for path, p in iter_linears(lp):
            q = get_by_path(lq, path)
            if "qweight" not in p:
                assert torch.equal(q["kernel"], p["kernel"].half())
                continue
            n += 1
            assert torch.equal(q["qweight"], p["qweight"])
            assert torch.equal(q["qzeros"], p["qzeros"])
            assert torch.equal(q["scales"], p["scales"].half().float())
    assert n == (7 if name == "llama" else 16) * len(model.params["layers"])


def test_sharded_save_loads_in_both(tmp_path, rng):
    model = port_quantized(LLAMA, seed=2)
    model.save_quantized(str(tmp_path), shard_bytes=64 * 1024)
    with open(tmp_path / "model.safetensors.index.json") as f:
        index = json.load(f)
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 2 and not (tmp_path / "model.safetensors").exists()
    sd = {}
    for s in shards:
        sd.update(load_file(str(tmp_path / s)))
    assert set(sd) == set(index["weight_map"])
    assert index["metadata"]["total_size"] == sum(
        t.numel() * t.element_size() for t in sd.values())
    toks = rng.integers(0, LLAMA["vocab_size"], (1, 9))
    jcfg, _, jparams = jser.from_quantized(str(tmp_path))
    ref = np.asarray(jm.forward(jcfg, jax.tree_util.tree_map(
        jnp.asarray, f32(jparams)), jnp.asarray(toks), method="jnp",
        dtype=jnp.float32))
    got = AutoAWQForCausalLM.from_quantized(
        str(tmp_path), device="cpu", dtype=torch.float32)(toks)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_config_json_equals_jax(tmp_path):
    jcfg, jqcfg, jparams = jax_rtn(LLAMA)
    jser.save_quantized(str(tmp_path / "jax"), jcfg, jqcfg, jparams)
    cfg = ModelConfig(**LLAMA)
    serialize.save_quantized(str(tmp_path / "port"), cfg,
                             AwqConfig(q_group_size=32),
                             from_jax_params(cfg, jparams))
    raw = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "config.json") as f:
            raw[side] = json.load(f)
    assert raw["port"]["quantization_config"] == \
        raw["jax"]["quantization_config"]
    assert ModelConfig.from_hf_dict(raw["port"]) == cfg
    a = load_file(str(tmp_path / "jax" / "model.safetensors"))
    b = load_file(str(tmp_path / "port" / "model.safetensors"))
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def write_fp_checkpoint(path, d, seed=0, src_files=()):
    """A float HF checkpoint (f32 weights) of the port's seeded model."""
    cfg = ModelConfig(**d)
    params = hf.init_random_params(cfg, seed=seed, device="cpu")
    os.makedirs(path, exist_ok=True)
    raw = cfg.to_hf_dict()
    raw.update(bos_token_id=1, eos_token_id=2)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f)
    serialize.write_safetensors(path, hf.state_dict_from_params(
        cfg, params, hf.role_out_features(cfg), dtype=torch.float32))
    for name in src_files:
        with open(os.path.join(path, name), "w") as f:
            f.write(name)
    return params


@pytest.mark.parametrize("name", list(MODELS))
def test_from_pretrained_equals_jax(tmp_path, name):
    d = MODELS[name]
    written = write_fp_checkpoint(str(tmp_path), d)
    jcfg, jparams = jser.from_pretrained(str(tmp_path))
    cfg, params = serialize.from_pretrained(str(tmp_path), device="cpu")
    assert cfg == ModelConfig(**d)
    ref = from_jax_params(cfg, jparams)
    for tree in (ref, written):
        flat_a = jax.tree_util.tree_leaves_with_path(params)
        flat_b = jax.tree_util.tree_leaves_with_path(tree)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_a, flat_b):
            assert a.dtype == torch.float32
            assert torch.equal(a, b), path


def test_facade_quantize_save_load_generate(tmp_path, rng):
    """from_pretrained -> quantize (token-id lists) -> save_quantized ->
    from_quantized, on the CPU: tokenizer files travel with the
    checkpoint, and the loaded model's logits equal the quantized model's
    with its scales rounded to fp16."""
    src, dst = str(tmp_path / "fp"), str(tmp_path / "awq")
    write_fp_checkpoint(src, LLAMA, src_files=("tokenizer.json",
                                               "tokenizer.model",
                                               "notes.txt"))
    model = AutoAWQForCausalLM.from_pretrained(src, device="cpu")
    assert model.device == torch.device("cpu")
    calib = [rng.integers(0, 256, int(n)).tolist()
             for n in rng.integers(10, 40, 30)]
    model.quantize(calib_data=calib, max_calib_samples=16,
                   max_calib_seq_len=32, quant_config={"q_group_size": 32},
                   progress=False)
    assert all(t.device.type == "cpu" for _, p in iter_linears(
        model.params["layers"][0]) for t in p.values())
    model.save_quantized(dst)
    names = set(os.listdir(dst))
    assert {"tokenizer.json", "tokenizer.model", "generation_config.json",
            "config.json", "model.safetensors"} <= names
    assert "notes.txt" not in names
    with open(os.path.join(dst, "generation_config.json")) as f:
        assert json.load(f) == {"bos_token_id": 1, "eos_token_id": 2}
    assert serialize.copy_aux_files(src, str(tmp_path / "awq")) == \
        jser.copy_aux_files(src, str(tmp_path / "awq"))

    loaded = AutoAWQForCausalLM.from_quantized(dst, device="cpu",
                                               dtype=torch.float32)
    # every float the checkpoint holds is fp16: scales, folded norms,
    # embedding, lm_head
    mem = jax.tree_util.tree_map(
        lambda t: t.half().float() if t.is_floating_point() else t,
        model.params)
    toks = rng.integers(0, 256, (2, 10))
    ref = modules.forward(model.cfg, mem, torch.from_numpy(toks),
                          method="plain")
    torch.testing.assert_close(loaded(toks, method="plain"), ref,
                               rtol=0, atol=1e-6 * ref.abs().max().item())
    out = loaded.generate(toks, max_new_tokens=4, dtype=torch.float32)
    assert out.shape == (2, 14)


def test_export_compatible_then_pack_through_the_facade(tmp_path, rng):
    model = AwqCausalLM(ModelConfig(**LLAMA), hf.init_random_params(
        ModelConfig(**LLAMA), seed=4, device="cpu"), device="cpu")
    with pytest.raises(RuntimeError, match="quantize"):
        model.pack()
    model.quantize(calib_data=rng.integers(0, 256, (2, 16)),
                   quant_config={"q_group_size": 32}, export_compatible=True,
                   progress=False)
    assert "kernel" in model.params["layers"][0]["mlp"]["down_proj"]
    model.pack()
    assert "qweight" in model.params["layers"][0]["mlp"]["down_proj"]
    model.save_quantized(str(tmp_path))
    assert (tmp_path / "model.safetensors").exists()


def test_save_refuses_other_versions(tmp_path):
    """gemv, gemv_fast and marlin are written now (their parity cases are in
    tests/test_torch_interop.py); what stays refused is a layout the
    weights cannot take, marlin with zero points, and an unquantized
    model."""
    cfg = ModelConfig(**LLAMA)
    params = random_quantized_params(cfg, seed=0, group_size=32,
                                     device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        serialize.save_quantized(str(tmp_path), cfg,
                                 AwqConfig(q_group_size=32,
                                           version="marlin"), params)
    with pytest.raises(RuntimeError, match="not quantized"):
        AwqCausalLM(cfg, {}, device="cpu").save_quantized(str(tmp_path))


def test_from_pretrained_defaults_to_the_card(tmp_path, monkeypatch):
    write_fp_checkpoint(str(tmp_path), LLAMA)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (AwqCausalLM.from_pretrained,
                 AutoAWQForCausalLM.from_pretrained,
                 serialize.from_pretrained):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hf.init_random_params(ModelConfig(**LLAMA))
    model = AwqCausalLM.from_pretrained(str(tmp_path), device="cpu")
    # the facade quantizes on its own device, not on a default one
    model.quantize(calib_data=np.zeros((1, 16), np.int64),
                   quant_config={"q_group_size": 32}, progress=False)
    assert model.params["layers"][0]["mlp"]["up_proj"]["qweight"].device \
        == torch.device("cpu")
