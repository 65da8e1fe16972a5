"""``to_device`` on the vision-language facades in JAX's chain
``from_quantized(path).to_device()``: each returns the facade, casts the
tower's and the language model's float leaves to bf16 (scales stay f32,
``_extra`` as it is) and keeps the tree on the facade's device. Each tiny
checkpoint (seeded transformers weights) is quantized and saved by the JAX
package and loaded by both. Tolerance: the port's logits within 3e-2 of the
logit scale of JAX's chain's (bf16 weights on both sides)."""

import numpy as np
import pytest
import torch

from autoawq_tpu import api as japi
from autoawq_tpu_torch import AwqLlavaModel, AwqQwen2VLModel
from torch_vl_util import (IMG_TOK, LLAVA_IMG, ids_with_runs, tiny_llava,
                           tiny_qwen_vl, write_dir)

QC = {"w_bit": 4, "q_group_size": 32, "zero_point": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_checkpoint(tmp_path, cls, raw, sd):
    src = write_dir(tmp_path / "src", raw, sd)
    calib = np.random.default_rng(1).integers(0, 128, (4, 32))
    jm = cls.from_pretrained(src)
    jm.quantize(None, QC, calib_data=calib, progress=False)
    out = str(tmp_path / "jax")
    jm.save_quantized(out)
    return out


def _check_cast(m):
    lm = m.params["language_model"]
    q = lm["layers"][0]["self_attn"]["q_proj"]
    assert q["scales"].dtype == torch.float32
    assert q["qweight"].dtype == torch.int32
    assert lm["embed_tokens"]["weight"].dtype == torch.bfloat16
    tower = [v for k, v in m.params.items() if k != "language_model"]
    floats = [t for t in _leaves(tower) if t.is_floating_point()]
    assert floats and all(t.dtype == torch.bfloat16 for t in floats)
    assert all(t.device.type == "cpu" for t in _leaves(m.params))


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k, v in tree.items() if k != "_extra"
                for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_llava_to_device_chain(tmp_path):
    path = _jax_checkpoint(tmp_path, japi.AwqLlavaModel, *tiny_llava())
    rng = np.random.default_rng(0)
    ids = rng.integers(6, 128, (1, 12))
    ids[0, 2:6] = LLAVA_IMG
    px = rng.standard_normal((1, 3, 16, 16)).astype(np.float32)
    want = np.asarray(japi.AwqLlavaModel.from_quantized(path).to_device()(
        ids, px), dtype=np.float32)

    m = AwqLlavaModel.from_quantized(path, device="cpu", dtype=None)
    assert m.to_device() is m
    _check_cast(m)
    got = m(ids, px).float().numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_qwen_vl_to_device_chain(tmp_path):
    path = _jax_checkpoint(tmp_path, japi.AwqQwen2VLModel,
                           *tiny_qwen_vl(False))
    grid = (1, 8, 8)
    rng = np.random.default_rng(2)
    ids = ids_with_runs(rng, [(IMG_TOK, grid)], s=32)
    patches = (rng.standard_normal((64, 96)) * 2).astype(np.float32)
    want = np.asarray(japi.AwqQwen2VLModel.from_quantized(path).to_device()(
        ids, patches, [grid]), dtype=np.float32)

    m = AwqQwen2VLModel.from_quantized(path, device="cpu", dtype=None)
    assert m.to_device() is m
    _check_cast(m)
    got = m(ids, patches, [grid]).float().numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
