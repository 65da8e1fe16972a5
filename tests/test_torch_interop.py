"""Checkpoint breadth in the port held against the JAX package on the CPU:
the gemv / gemv_fast / marlin codecs (``io/interop``), checkpoints written
by either package in each version and read by the other, lm_head
quantization, the per-layer calibration resume, the whole-tree checkpoint
and the host packer (``core/native``).

Tolerances: packed tensors, checkpoint tensors, clip max-vals and nibbles
equal (no tolerance); logits of two checkpoints holding the same numbers
equal exactly; the quantized head's f32 logits within the JAX test's
bounds of the float head's (KL below 0.05 nats, max difference below half
the logit scale: int4 g32 on a 64-wide head is coarse)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import interop as jinterop
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.io.hf import init_random_params as jax_init
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.quantize.quantizer import AwqQuantizer as JaxQuantizer
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch import AwqCausalLM
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.convert import from_jax_params, lin_from_planar
from autoawq_tpu_torch.core import native, packing
from autoawq_tpu_torch.io import ckpt, interop, serialize
from autoawq_tpu_torch.io.hf import init_random_params
from autoawq_tpu_torch.io.safetensors import load_file
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer

KW = dict(model_type="llama", vocab_size=128, hidden_size=128,
          intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=32, max_position_embeddings=64)
# the JAX lm_head test's config (tests/test_lm_head_quant.py)
HEAD = dict(model_type="llama", vocab_size=256, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            max_position_embeddings=64)
VERSIONS = ("gemv", "gemv_fast", "marlin")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops: one intra-op thread, so the suite's workers do
    not spin against each other. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _triple(k, n, g, version, seed=0):
    rng = np.random.default_rng(seed)
    q4 = rng.integers(0, 16, (k, n)).astype(np.int32)
    z4 = (np.full((k // g, n), 8, np.int32) if version == "marlin"
          else rng.integers(0, 16, (k // g, n)).astype(np.int32))
    sc = ((rng.random((k // g, n)) + 0.5) * 0.01).astype(np.float32)
    return q4, z4, sc


# ------------------------------------------------------------ codecs

@pytest.mark.parametrize("g", [32, 64, 128])
@pytest.mark.parametrize("k,n", [(256, 128), (512, 192)])
@pytest.mark.parametrize("version", VERSIONS)
def test_packed_bits_equal_jax_both_ways(version, k, n, g):
    q4, z4, sc = _triple(k, n, g, version)
    pack = getattr(interop, f"pack_{version}")
    jpack = getattr(jinterop, f"pack_{version}")
    got, want = pack(q4, z4, sc, g), jpack(q4, z4, sc, g)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if version == "marlin":
        back = interop.unpack_marlin(got[0], got[1], g)
        jback = jinterop.unpack_marlin(want[0], want[1], g)
    else:
        back = getattr(interop, f"unpack_{version}")(*got, g)
        jback = getattr(jinterop, f"unpack_{version}")(*want, g)
    for a, b, orig in zip(back, jback, (q4, z4, sc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back[0], q4)
    np.testing.assert_array_equal(back[1], z4)
    np.testing.assert_array_equal(back[2],
                                  sc.astype(np.float16).astype(np.float32))


def test_zeros_width_and_marlin_refusals_equal_jax():
    for k in (256, 2048, 4544):
        for g in (32, 64, 128):
            assert interop.zeros_width(k, g) == jinterop.zeros_width(k, g)
    q4, z4, sc = _triple(256, 128, 32, "gemv")
    with pytest.raises(ValueError, match="symmetric"):
        interop.pack_marlin(q4, z4, sc, 32)


# ------------------------------------------------------------ checkpoints

def _jax_model(seed=0, zero_point=True):
    jcfg = JaxConfig(**KW)
    return jcfg, jax_synth(jcfg, seed=seed, group_size=32,
                           zero_point=zero_point)


def _port_logits(path, tokens):
    cfg, _, params = serialize.from_quantized(path, device="cpu")
    return modules.forward(cfg, params, torch.from_numpy(tokens),
                           method="plain")


def _jax_logits(path, tokens):
    jcfg, _, params = jser.from_quantized(path)
    return np.asarray(jm.forward(jcfg, params, jnp.asarray(tokens),
                                 method="jnp"))


@pytest.mark.parametrize("version", VERSIONS)
def test_jax_written_checkpoints_load_in_the_port(tmp_path, rng, version):
    zp = version != "marlin"
    jcfg, jp = _jax_model(zero_point=zp)
    gemm, other = str(tmp_path / "gemm"), str(tmp_path / version)
    jser.save_quantized(gemm, jcfg, JaxAwqConfig(q_group_size=32,
                                                 zero_point=zp), jp)
    jser.save_quantized(other, jcfg, JaxAwqConfig(
        q_group_size=32, zero_point=zp, version=version), jp)
    tokens = rng.integers(0, KW["vocab_size"], (2, 12))
    _, qcfg, _ = serialize.from_quantized(other, device="cpu")
    assert qcfg.version == version
    torch.testing.assert_close(_port_logits(other, tokens),
                               _port_logits(gemm, tokens), rtol=0, atol=0)


@pytest.mark.parametrize("version", VERSIONS)
def test_port_written_checkpoints_equal_jax_s_and_load_in_jax(
        tmp_path, rng, version):
    zp = version != "marlin"
    jcfg, jp = _jax_model(seed=1, zero_point=zp)
    cfg = ModelConfig(**KW)
    pp = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jp))
    qcfg = AwqConfig(q_group_size=32, zero_point=zp, version=version)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    serialize.save_quantized(port_dir, cfg, qcfg, pp)
    jser.save_quantized(jax_dir, jcfg, JaxAwqConfig(
        q_group_size=32, zero_point=zp, version=version), jp)
    got = load_file(os.path.join(port_dir, "model.safetensors"))
    want = load_file(os.path.join(jax_dir, "model.safetensors"))
    quantized = [k for k in want if k.endswith((".qweight", ".qzeros",
                                                ".scales"))]
    assert quantized and all(k in got for k in quantized)
    for key in quantized:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    assert (".qzeros" in " ".join(got)) == zp
    tokens = rng.integers(0, KW["vocab_size"], (2, 12))
    np.testing.assert_array_equal(_jax_logits(port_dir, tokens),
                                  _jax_logits(jax_dir, tokens))


def test_non_4_bit_checkpoints_refuse_to_load(tmp_path):
    cfg = ModelConfig(**KW)
    params = from_jax_params(cfg, jax.tree_util.tree_map(
        np.asarray, _jax_model()[1]))
    serialize.save_quantized(str(tmp_path), cfg, AwqConfig(q_group_size=32),
                             params)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(cfg_path.read_text().replace('"bits": 4',
                                                     '"bits": 8'))
    with pytest.raises(NotImplementedError, match="4-bit"):
        serialize.from_quantized(str(tmp_path), device="cpu")


# ------------------------------------------------------------ lm_head

class RecordingJaxQuantizer(JaxQuantizer):
    """JAX's quantizer, recording its clip searches' inputs and results."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.clip_calls = []

    def _search_best_clip(self, w, inp):
        out = super()._search_best_clip(w, inp)
        self.clip_calls.append((np.asarray(w), np.asarray(inp),
                                np.asarray(out)))
        return out


def test_lm_head_clip_choices_and_packed_head_equal_jax(rng):
    jcfg, cfg = JaxConfig(**HEAD), ModelConfig(**HEAD)
    calib = rng.integers(0, HEAD["vocab_size"], (2, 16))
    jq = RecordingJaxQuantizer(jcfg, JaxAwqConfig(q_group_size=32),
                               jax_init(jcfg, seed=3), calib, progress=False,
                               quantize_lm_head=True)
    jout = jq.quantize()
    w, hin, jmax = jq.clip_calls[-1]  # the head's search is the last
    assert w.shape == (HEAD["hidden_size"], HEAD["vocab_size"])
    q = AwqQuantizer(cfg, AwqConfig(q_group_size=32), init_random_params(
        cfg, seed=3, device="cpu"), calib, progress=False, device="cpu")
    got = q._search_best_clip(torch.tensor(w), torch.tensor(hin))
    np.testing.assert_array_equal(got.numpy(), jmax)
    # the port's packing of JAX's clipped head equals JAX's packed head
    from autoawq_tpu_torch.quantize import scale as scale_mod
    from autoawq_tpu_torch.quantize.quantizer import quantize_linear_params

    head = {"lm_head": {"kernel": torch.tensor(w)}}
    scale_mod.apply_clip(head, "lm_head", got)
    mine = quantize_linear_params(head["lm_head"], AwqConfig(q_group_size=32))
    want = lin_from_planar(jax.tree_util.tree_map(
        np.asarray, jout["lm_head"]), HEAD["vocab_size"])
    for leaf in ("qweight", "scales", "qzeros"):
        assert torch.equal(mine[leaf], want[leaf]), leaf


def test_lm_head_quantized_bounded_and_round_trips(rng, tmp_path):
    cfg = ModelConfig(**HEAD)
    calib = rng.integers(0, HEAD["vocab_size"], (2, 16))

    def run(**kw):
        return AwqQuantizer(cfg, AwqConfig(q_group_size=32),
                            init_random_params(cfg, seed=3, device="cpu"),
                            calib, progress=False, device="cpu",
                            **kw).quantize()
    base, withhead = run(), run(quantize_lm_head=True)
    assert "qweight" in withhead["lm_head"]
    assert "kernel" not in withhead["lm_head"]
    tokens = torch.from_numpy(rng.integers(0, HEAD["vocab_size"], (2, 12)))
    ref = modules.forward(cfg, base, tokens, method="plain")
    got = modules.forward(cfg, withhead, tokens, method="plain")
    assert (got - ref).abs().max() < 0.5 * ref.abs().max()
    kl = (torch.softmax(ref, -1) * (torch.log_softmax(ref, -1)
                                    - torch.log_softmax(got, -1))).sum(-1)
    assert kl.max() < 0.05, kl.max()
    model = AwqCausalLM(cfg, withhead, AwqConfig(q_group_size=32),
                        device="cpu")
    model.save_quantized(str(tmp_path))
    _, _, loaded = serialize.from_quantized(str(tmp_path), device="cpu")
    assert "qweight" in loaded["lm_head"]
    # the checkpoint keeps float tensors and scales in fp16: the reload is
    # the model in memory with those so rounded
    torch.testing.assert_close(
        modules.forward(cfg, loaded, tokens, method="plain",
                        dtype=torch.float32),
        modules.forward(cfg, _fp16(withhead), tokens, method="plain",
                        dtype=torch.float32),
        rtol=0, atol=1e-5 * got.abs().max().item())


def _fp16(tree):
    if isinstance(tree, dict):
        return {k: _fp16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fp16(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.half().float()
    return tree


def test_tied_embeddings_skip_the_head(rng):
    cfg = ModelConfig(**dict(HEAD, num_hidden_layers=1,
                             tie_word_embeddings=True))
    params = init_random_params(cfg, seed=4, device="cpu")
    assert params.get("lm_head") is None
    out = AwqQuantizer(cfg, AwqConfig(q_group_size=32), params,
                       rng.integers(0, HEAD["vocab_size"], (2, 16)),
                       progress=False, quantize_lm_head=True,
                       device="cpu").quantize()
    assert out.get("lm_head") is None


# ------------------------------------------------------------ resume

def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _resume_run(cfg, params, calib, resume, **kw):
    return AwqQuantizer(cfg, AwqConfig(q_group_size=32), params, calib,
                        progress=False, resume_dir=resume, device="cpu",
                        **kw).quantize()


def test_resumed_quantization_equals_an_uninterrupted_one(rng, tmp_path):
    cfg = ModelConfig(**dict(KW, num_hidden_layers=3))
    params = init_random_params(cfg, seed=0, scale=0.1, device="cpu")
    calib = rng.integers(0, KW["vocab_size"], (4, 32))
    plain = _resume_run(cfg, params, calib, None)
    resume = str(tmp_path / "resume")
    first = _resume_run(cfg, params, calib, resume)
    assert sorted(os.listdir(resume)) == [f"layer_000{i}.pt"
                                          for i in range(3)]
    _assert_trees_equal(first, plain)
    # a run cut after layer 1: its last file is gone, layers 0-1 load
    os.remove(os.path.join(resume, "layer_0002.pt"))
    q = AwqQuantizer(cfg, AwqConfig(q_group_size=32), params, calib,
                     progress=False, resume_dir=resume, device="cpu")
    resumed = q.quantize()
    assert len(q.all_scales) == 1  # only layer 2 was searched
    _assert_trees_equal(resumed, plain)
    # every layer from its file, the lm_head quantized after them
    again = _resume_run(cfg, params, calib, resume, keep_on_device=True,
                        quantize_lm_head=True)
    _assert_trees_equal(again["layers"], plain["layers"])
    assert "qweight" in again["lm_head"]


def test_facade_quantizes_with_resume_dir(rng, tmp_path):
    cfg = ModelConfig(**KW)
    model = AwqCausalLM(cfg, init_random_params(cfg, seed=2, device="cpu"),
                        device="cpu")
    resume = str(tmp_path / "r")
    model.quantize(calib_data=rng.integers(0, KW["vocab_size"], (2, 16)),
                   quant_config={"q_group_size": 32}, resume_dir=resume,
                   progress=False)
    assert sorted(os.listdir(resume)) == ["layer_0000.pt", "layer_0001.pt"]
    assert "qweight" in model.params["layers"][1]["mlp"]["down_proj"]


# ------------------------------------------------------------ whole tree

def test_whole_tree_checkpoint_round_trips(tmp_path, monkeypatch):
    cfg = ModelConfig(**KW)
    params = from_jax_params(cfg, jax.tree_util.tree_map(
        np.asarray, _jax_model(seed=5)[1]))
    params["lm_head"] = None
    params["layers"][0]["self_attn"]["q_proj"]["lora_a"] = torch.ones(
        128, 4, dtype=torch.bfloat16)
    path = str(tmp_path / "ckpt")
    ckpt.save(path, params)
    assert os.listdir(path) == ["params.pt"]
    _assert_trees_equal(ckpt.load(path, device="cpu"), params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.load(path)


# ------------------------------------------------------------ host packer

@pytest.mark.parametrize("k,n", [(64, 48), (37, 40), (200, 1000)])
def test_native_packer_bit_equal_numpy(k, n):
    q4 = np.random.default_rng(k).integers(0, 16, (k, n))
    np.testing.assert_array_equal(native.pack_awq(q4), packing.pack_awq(q4))
    words = packing.pack_awq(q4)
    for width in (n, n - 3):
        np.testing.assert_array_equal(native.unpack_awq(words, width),
                                      packing.unpack_awq(words, width))
    port = packing.pack_port(q4)
    np.testing.assert_array_equal(native.pack_port(q4), port.numpy())
    for rows, cols in ((k, n), (k - 5, n - 7)):
        np.testing.assert_array_equal(
            native.unpack_port(port.numpy(), rows, cols),
            packing.unpack_port(port, rows)[:, :cols].numpy())
    with pytest.raises(ValueError, match="N % 8"):
        native.pack_awq(q4[:, :n - 3])
