"""Checkpoint tensors that the layer map does not model round-trip through
the port as through the JAX package: JAX keeps every key its loader did
not read in ``params["_extra"]`` and ``save_quantized`` writes it back
(f32 as f16). The port's loaders (``from_quantized``, ``from_pretrained``)
and every walk over the tree (``cast_params``, ``fuse_model``,
``to_device``, the quantizer's result) keep them too. Key sets and values
must equal JAX's save exactly (no tolerance)."""

import json
import os

import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.models.config import ModelConfig as JaxModelConfig
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch import AwqCausalLM
from autoawq_tpu_torch.api import cast_params
from autoawq_tpu_torch.io import serialize
from autoawq_tpu_torch.io.safetensors import load_file
from autoawq_tpu_torch.nn import fuse
from autoawq_tpu_torch.utils.tree import to_device

LLAMA = dict(model_type="llama", vocab_size=256, hidden_size=128,
             intermediate_size=256, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=32,
             max_position_embeddings=64)
EXTRA_KEY = "model.vision_embed_tokens.img_projection.0.weight"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_dir(path):
    files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    sd = {}
    for f in files:
        sd.update(load_file(os.path.join(path, f)))
    return sd


def _jax_saved(tmp_path):
    """A tiny llama, g64, with one unmodeled f16 tensor, saved by JAX."""
    jcfg = JaxModelConfig(**LLAMA)
    params = jax_synth(jcfg, seed=0, group_size=64)
    params["_extra"] = {EXTRA_KEY: np.ones((8, 8), np.float16)}
    path = str(tmp_path / "jax")
    jser.save_quantized(path, jcfg, JaxAwqConfig(q_group_size=64), params)
    return path


def _same_dirs(a, b):
    sa, sb = _read_dir(a), _read_dir(b)
    assert set(sa) == set(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


def test_from_quantized_keeps_and_writes_back_unmodeled_tensors(tmp_path):
    path = _jax_saved(tmp_path)
    assert EXTRA_KEY in _read_dir(path)
    # JAX's own reload keeps it
    _, _, jparams = jser.from_quantized(path)
    assert EXTRA_KEY in jparams["_extra"]
    cfg, qcfg, params = serialize.from_quantized(path, device="cpu")
    assert set(params["_extra"]) == set(jparams["_extra"])
    extra = params["_extra"][EXTRA_KEY]
    assert extra.device.type == "cpu" and extra.dtype == torch.float16
    assert torch.equal(extra, torch.ones(8, 8, dtype=torch.float16))
    out = str(tmp_path / "port")
    serialize.save_quantized(out, cfg, qcfg, params)
    _same_dirs(path, out)


def test_tree_walks_leave_extra_alone(tmp_path):
    path = _jax_saved(tmp_path)
    cfg, qcfg, params = serialize.from_quantized(path, device="cpu")
    extra = params["_extra"]
    cast = cast_params(params, torch.bfloat16)
    assert cast["_extra"][EXTRA_KEY].dtype == torch.float16
    moved = to_device(cast, "cpu", torch.bfloat16)
    assert moved["_extra"] is extra
    fused = fuse.fuse_model(cfg, moved)
    assert fused["_extra"] is extra
    out = str(tmp_path / "port")
    serialize.save_quantized(out, cfg, qcfg, fused)
    assert EXTRA_KEY in _read_dir(out)


def test_facade_load_fuse_save_keeps_unmodeled_tensors(tmp_path):
    path = _jax_saved(tmp_path)
    m = AwqCausalLM.from_quantized(path, fuse_layers=True, device="cpu")
    assert m.params["_extra"][EXTRA_KEY].dtype == torch.float16
    out = str(tmp_path / "port")
    m.save_quantized(out)
    got = _read_dir(out)
    assert torch.equal(got[EXTRA_KEY], torch.ones(8, 8, dtype=torch.float16))


def _float_dir(tmp_path):
    """A float checkpoint (the JAX save's dequantized twin is not needed:
    a float llama written by the port's writer) plus an unmodeled f32
    tensor."""
    from autoawq_tpu_torch.io import hf
    from autoawq_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(**LLAMA)
    params = hf.init_random_params(cfg, seed=0, device="cpu")
    sd = hf.state_dict_from_params(cfg, params, hf.role_out_features(cfg),
                                   torch.float32)
    sd[EXTRA_KEY] = torch.full((8, 8), 0.5)
    path = str(tmp_path / "fp")
    os.makedirs(path)
    serialize.write_safetensors(path, sd)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg.to_hf_dict(), f)
    return path


def test_from_pretrained_and_quantize_save_match_jax(tmp_path):
    """Float checkpoint -> quantize -> save, in both packages (text
    calibration, no clip search so the nibbles agree exactly): the key
    sets are equal and the unmodeled tensor is written as f16 by both."""
    from autoawq_tpu.api import AwqCausalLM as JaxLM

    path = _float_dir(tmp_path)
    calib = np.random.default_rng(0).integers(0, 256, (2, 32))
    qc = {"w_bit": 4, "q_group_size": 64, "zero_point": True}
    jm = JaxLM.from_pretrained(path)
    assert jm.params["_extra"][EXTRA_KEY].dtype == np.float32
    jm.quantize(None, qc, calib_data=calib, apply_clip=False, progress=False)
    jout = str(tmp_path / "jq")
    jm.save_quantized(jout)

    m = AwqCausalLM.from_pretrained(path, device="cpu")
    assert m.params["_extra"][EXTRA_KEY].dtype == torch.float32
    m.quantize(None, qc, calib_data=calib, apply_clip=False, progress=False)
    assert m.params["_extra"][EXTRA_KEY].device.type == "cpu"
    out = str(tmp_path / "pq")
    m.save_quantized(out)
    sj, sp = _read_dir(jout), _read_dir(out)
    assert set(sj) == set(sp)
    assert sp[EXTRA_KEY].dtype == torch.float16
    assert torch.equal(sj[EXTRA_KEY], sp[EXTRA_KEY])
