"""The port's multimodal facades against the JAX package's, on tiny
checkpoints written here (seeded transformers weights): the routing of
``AutoAWQForCausalLM`` on the four vision-language types, the LLaVA and
Qwen2-VL facades' load, quantize, save and reload, and phi3_v, whose image
embedder rides ``params["_extra"]`` through quantize and save. Tolerances:
key sets and the unmodeled tensor exactly; a reload's logits within 1e-5
of the in-memory model's scale (the same int4 tree; float leaves through
f16 are compared after the same rounding); the port's quantized logits
within 5e-2 of JAX's (its quantizer differs by the clip search's
round-half ties, ``tests/test_torch_quantizer.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from autoawq_tpu import api as japi
from autoawq_tpu_torch import (AutoAWQForCausalLM, AwqCausalLM,
                               AwqLlavaModel, AwqQwen2VLModel)
from autoawq_tpu_torch.io.safetensors import load_file
from test_torch_zoo import _case
from torch_vl_util import (IMG_TOK, LLAVA_IMG, ids_with_runs, rel_err,
                           tiny_llava, tiny_llava_next, tiny_qwen_vl,
                           write_dir)

QC = {"w_bit": 4, "q_group_size": 32, "zero_point": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _saved(path):
    sd = {}
    for f in os.listdir(path):
        if f.endswith(".safetensors"):
            sd.update(load_file(os.path.join(path, f)))
    return sd


@pytest.mark.parametrize("kind,cls", [
    ("llava", AwqLlavaModel), ("llava_next", AwqLlavaModel),
    ("qwen2_vl", AwqQwen2VLModel), ("qwen2_5_vl", AwqQwen2VLModel),
    ("llama", AwqCausalLM)])
def test_routing_on_model_type(tmp_path, kind, cls):
    raw, sd = {"llava": tiny_llava, "llava_next": tiny_llava_next,
               "qwen2_vl": lambda: tiny_qwen_vl(False),
               "qwen2_5_vl": lambda: tiny_qwen_vl(True),
               "llama": lambda: _case("llama")}[kind]()
    assert raw["model_type"] == kind
    path = write_dir(tmp_path / kind, raw, sd)
    m = AutoAWQForCausalLM.from_pretrained(path, device="cpu")
    assert type(m) is cls
    assert type(japi.AutoAWQForCausalLM.from_pretrained(path)).__name__ == \
        cls.__name__
    assert m.device.type == "cpu"


def test_facades_run_on_the_card_by_default(tmp_path, monkeypatch):
    raw, sd = tiny_llava()
    path = write_dir(tmp_path / "l", raw, sd)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoAWQForCausalLM.from_pretrained(path)
    with pytest.raises(FileNotFoundError, match="local directory"):
        AwqLlavaModel.from_pretrained(str(tmp_path / "absent"),
                                      device="cpu")


def _llava_inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(6, 128, (1, 12))
    ids[0, 2:6] = LLAVA_IMG
    return ids, rng.standard_normal((1, 3, 16, 16)).astype(np.float32)


def test_llava_quantize_save_reload_equals_jax(tmp_path):
    raw, sd = tiny_llava()
    src = write_dir(tmp_path / "src", raw, sd)
    calib = np.random.default_rng(1).integers(0, 128, (4, 32))
    ids, px = _llava_inputs()

    jm = japi.AwqLlavaModel.from_pretrained(src)
    jm.quantize(None, QC, calib_data=calib, progress=False)
    jm.save_quantized(str(tmp_path / "jax"))
    want = np.asarray(jm(ids, px, method="jnp"))

    m = AwqLlavaModel.from_pretrained(src, device="cpu")
    m.quantize(None, QC, calib_data=calib, progress=False)
    assert "qweight" in m.params["language_model"]["layers"][0][
        "self_attn"]["q_proj"]
    mem = m(ids, px, dtype=torch.float32)
    assert rel_err(mem, want) < 5e-2
    out = str(tmp_path / "port")
    m.save_quantized(out)
    assert set(_saved(out)) == set(_saved(str(tmp_path / "jax")))
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    assert saved["quantization_config"]["quant_method"] == "awq"
    assert "autoawq_tpu_config" in saved["text_config"]

    back = AutoAWQForCausalLM.from_quantized(out, fuse_layers=True,
                                             device="cpu")
    assert isinstance(back, AwqLlavaModel)
    assert "qkv_proj" in back.params["language_model"]["layers"][0][
        "self_attn"]
    got = back(ids, px, dtype=torch.float32)
    # the reload's float leaves went through f16: compare with the
    # in-memory model after the same rounding
    m.params = _f16(m.params)
    assert rel_err(got, m(ids, px, dtype=torch.float32)) < 1e-5
    # generate: prefill from the spliced embeds, decode on ids
    toks = back.generate(ids, px, max_new_tokens=4, dtype=torch.float32)
    assert toks.shape == (1, 16)
    jtoks = japi.AwqLlavaModel.from_quantized(str(tmp_path / "jax")) \
        .generate(ids, px, max_new_tokens=4, method="jnp")
    assert jtoks.shape == (1, 16)
    cast = AwqLlavaModel.from_quantized(out, to_device=True,
                                        dtype=torch.bfloat16, device="cpu")
    assert cast.params["vision_tower"]["layers"][0]["fc1"][
        "kernel"].dtype == torch.bfloat16
    assert cast.params["language_model"]["layers"][0]["self_attn"][
        "q_proj"]["scales"].dtype == torch.float32


def _f16(tree):
    """Float leaves rounded through f16, as the writer stores them (the
    int4 scales are written in f16 too)."""
    if isinstance(tree, dict):
        return {k: _f16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f16(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.half().to(tree.dtype)
    return tree


@pytest.mark.parametrize("is_25", [False, True])
def test_qwen_vl_image_conditioned_quantize_save_reload(tmp_path, is_25):
    raw, sd = tiny_qwen_vl(is_25)
    src = write_dir(tmp_path / "src", raw, sd)
    grid = (1, 8, 8)
    rng = np.random.default_rng(2)
    ids = np.concatenate([ids_with_runs(rng, [(IMG_TOK, grid)], s=32)
                          for _ in range(2)])
    patches = (rng.standard_normal((128, 96)) * 2).astype(np.float32)
    kw = dict(calib_data=ids, calib_patches=patches,
              calib_grid_thw=[grid, grid], progress=False)

    jm = japi.AwqQwen2VLModel.from_pretrained(src)
    jm.quantize(quant_config=QC, **kw)
    jm.save_quantized(str(tmp_path / "jax"))
    want = np.asarray(jm(ids[:1], patches[:64], [grid], method="jnp"))

    m = AutoAWQForCausalLM.from_pretrained(src, device="cpu")
    m.quantize(quant_config=QC, **kw)
    mem = m(ids[:1], patches[:64], [grid], dtype=torch.float32)
    assert rel_err(mem, want) < 5e-2
    out = str(tmp_path / "port")
    m.save_quantized(out)
    assert set(_saved(out)) == set(_saved(str(tmp_path / "jax")))
    back = AwqQwen2VLModel.from_quantized(out, device="cpu")
    assert back._is_25 == is_25
    got = back(ids[:1], patches[:64], [grid], dtype=torch.float32)
    m.params = _f16(m.params)
    assert rel_err(got, m(ids[:1], patches[:64], [grid],
                          dtype=torch.float32)) < 1e-5
    # text-only calibration takes the decoder's path
    t = AwqQwen2VLModel.from_pretrained(src, device="cpu")
    t.quantize(None, QC, calib_data=ids, progress=False)
    assert "qweight" in t.params["language_model"]["layers"][1]["mlp"][
        "down_proj"]


def test_phi3_v_keeps_its_image_embedder_through_quantize_and_save(
        tmp_path):
    raw, sd = _case("phi3")
    raw = {**raw, "model_type": "phi3_v"}
    extra = "model.vision_embed_tokens.img_projection.0.weight"
    sd = {**sd, extra: np.random.default_rng(3).standard_normal(
        (16, 8)).astype(np.float32)}
    src = write_dir(tmp_path / "src", raw, sd)
    calib = np.random.default_rng(4).integers(0, raw["vocab_size"], (2, 32))
    qc = {**QC, "q_group_size": 32}

    jm = japi.AwqCausalLM.from_pretrained(src)
    jm.quantize(None, qc, calib_data=calib, apply_clip=False,
                progress=False)
    jm.save_quantized(str(tmp_path / "jax"))

    m = AutoAWQForCausalLM.from_pretrained(src, device="cpu")
    assert isinstance(m, AwqCausalLM)
    m.quantize(None, qc, calib_data=calib, apply_clip=False, progress=False)
    assert m._quantizer.plugin.__name__ == "Phi3Plugin"
    assert m.params["_extra"][extra].dtype == torch.float32
    out = str(tmp_path / "port")
    m.save_quantized(out)
    mine, theirs = _saved(out), _saved(str(tmp_path / "jax"))
    assert set(mine) == set(theirs)
    assert mine[extra].dtype == torch.float16
    assert torch.equal(mine[extra], theirs[extra])
    back = AwqCausalLM.from_quantized(out, device="cpu")
    assert torch.equal(back.params["_extra"][extra], mine[extra])
