"""The decoder zoo on the CPU, at tiny sizes, against the JAX package.

(a) Every non-MLA, non-MoE architecture of ``tests/test_arch_parity.py``
(transformers models built from configs, no download), the remote-code
families built from the JAX package's seeded weights and its own writer,
and the two synthetic archs of ``tests/test_synth_archs.py`` (quantized,
through the JAX writer): the port's ``params_from_state_dict`` equals
JAX's leaf for leaf (carried by ``convert.from_jax_params``), its f32
plain forward agrees with JAX's ``method="jnp"`` within 1e-4 of the logit
scale (summation order only), and ``state_dict_from_params`` is bit-equal.
(b) Quantized synth trees per family through ``from_jax_params``: greedy
f32 streams of ``generate``, the slot pool and the paged engine (the K7
twin route and the gather route) equal JAX's token for token.
(c) ``rope_params`` equals JAX's bit for bit in all six flavours on both
sides of the original length; ALiBi slopes within 1e-6 relative (the
port's are correctly rounded, XLA's f32 ``pow`` drifts a few ulps).
(d) JAX-written AutoAWQ GEMM checkpoints load in the port's
``from_quantized(device="cpu")`` with JAX's logits (1e-4 of the scale).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.config import AwqConfig as JaxAwqConfig
from autoawq_tpu.io import hf as jhf
from autoawq_tpu.io import serialize as jser
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.serve import batching as jbatch
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.serve import paged as jpaged
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.io import hf, serialize
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.serve import batching, paged
from autoawq_tpu_torch.serve import generate as gen

B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Six xdist workers share the host: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close(a, b, tol=1e-4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


# --------------------------------------------------------------------------
# (a) checkpoint layouts and the f32 forward
# --------------------------------------------------------------------------

def _hf(name):
    """(transformers config, model class) of a test_arch_parity case."""
    import transformers as T

    small = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 max_position_embeddings=64)
    if name == "llama":
        return T.LlamaConfig(num_key_value_heads=2, **small), \
            T.LlamaForCausalLM
    if name == "opt":
        kw = {k: v for k, v in small.items() if k != "intermediate_size"}
        return T.OPTConfig(ffn_dim=128, word_embed_proj_dim=64,
                           do_layer_norm_before=True, **kw), \
            T.OPTForCausalLM
    if name == "bloom":
        return T.BloomConfig(vocab_size=128, hidden_size=64, n_layer=2,
                             n_head=4), T.BloomForCausalLM
    if name == "gptj":
        return T.GPTJConfig(vocab_size=128, n_embd=64, n_layer=2, n_head=4,
                            rotary_dim=8, n_positions=64), T.GPTJForCausalLM
    if name in ("gpt_neox", "gpt_neox_sequential"):
        par = name == "gpt_neox"
        return T.GPTNeoXConfig(rotary_pct=0.25 if par else 1.0,
                               use_parallel_residual=par, **small), \
            T.GPTNeoXForCausalLM
    if name == "gpt_bigcode":
        return T.GPTBigCodeConfig(
            vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
            multi_query=True, activation_function="gelu_pytorch_tanh"), \
            T.GPTBigCodeForCausalLM
    if name == "starcoder2":
        return T.Starcoder2Config(num_key_value_heads=2, use_bias=True,
                                  sliding_window=None, **small), \
            T.Starcoder2ForCausalLM
    if name == "mpt":
        from transformers.models.mpt.configuration_mpt import \
            MptAttentionConfig

        return T.MptConfig(vocab_size=128, d_model=64, n_layers=2,
                           n_heads=4, expansion_ratio=2, max_seq_len=64,
                           no_bias=True,
                           attn_config=MptAttentionConfig(alibi=True)), \
            T.MptForCausalLM
    if name in ("falcon_new_arch", "falcon_7b_style"):
        new = name == "falcon_new_arch"
        kw = dict(num_kv_heads=2) if new else dict(multi_query=True)
        return T.FalconConfig(vocab_size=128, hidden_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              new_decoder_architecture=new,
                              parallel_attn=True, bias=False, alibi=False,
                              max_position_embeddings=64, **kw), \
            T.FalconForCausalLM
    if name == "cohere":
        return T.CohereConfig(num_key_value_heads=4, logit_scale=0.125,
                              use_qk_norm=False, **small), \
            T.CohereForCausalLM
    if name == "gemma2":
        return T.Gemma2Config(num_key_value_heads=2, head_dim=16,
                              attn_logit_softcapping=50.0,
                              final_logit_softcapping=30.0,
                              query_pre_attn_scalar=16, sliding_window=256,
                              **small), T.Gemma2ForCausalLM
    if name == "phi3":
        return T.Phi3Config(num_key_value_heads=4, pad_token_id=0,
                            **small), T.Phi3ForCausalLM
    if name == "qwen2":
        return T.Qwen2Config(num_key_value_heads=2, **small), \
            T.Qwen2ForCausalLM
    if name == "gemma":
        return T.GemmaConfig(num_key_value_heads=2, head_dim=16,
                             hidden_activation="gelu_pytorch_tanh",
                             **small), T.GemmaForCausalLM
    if name == "stablelm":
        return T.StableLmConfig(num_key_value_heads=2,
                                partial_rotary_factor=0.25,
                                use_parallel_residual=False, **small), \
            T.StableLmForCausalLM
    if name == "qwen3":
        return T.Qwen3Config(num_key_value_heads=2, head_dim=16, **small), \
            T.Qwen3ForCausalLM
    raise KeyError(name)


HF_CASES = ["llama", "opt", "bloom", "gptj", "gpt_neox",
            "gpt_neox_sequential", "gpt_bigcode", "starcoder2", "mpt",
            "falcon_new_arch", "falcon_7b_style", "cohere", "gemma2", "phi3",
            "qwen2", "gemma", "stablelm", "qwen3"]

_SMALL = dict(vocab_size=128, hidden_size=64, num_attention_heads=4,
              max_position_embeddings=64)
# families whose modelling code is remote (not in transformers): HF config
# dicts, weights drawn by the JAX package and written by its writer
REMOTE_CASES = {
    "baichuan": dict(model_type="baichuan", intermediate_size=128,
                     num_hidden_layers=2, **_SMALL),
    "internlm2": dict(model_type="internlm2", intermediate_size=128,
                      num_hidden_layers=2, num_key_value_heads=2, bias=True,
                      **_SMALL),
    "exaone": dict(model_type="exaone", intermediate_size=128, num_layers=2,
                   num_key_value_heads=2, **_SMALL),
    "qwen": dict(model_type="qwen", intermediate_size=256,
                 num_hidden_layers=2, **_SMALL),
    "minicpm": dict(model_type="minicpm", intermediate_size=128,
                    num_hidden_layers=2, num_key_value_heads=2,
                    scale_emb=12.0, scale_depth=1.4, dim_model_base=32,
                    **_SMALL),
}

# the two archs of tests/test_synth_archs.py (ModelConfig fields)
SYNTH_ARCHS = {
    "synth_mpt": dict(model_type="mpt", pos_embed="alibi", hidden_act="gelu",
                      norm_kind="ln", gated_mlp=False,
                      tie_word_embeddings=True, num_attention_heads=4,
                      num_key_value_heads=4, head_dim=32),
    "synth_falcon": dict(model_type="falcon", hidden_act="gelu",
                         norm_kind="ln", parallel_residual=True,
                         shared_input_norm=True, gated_mlp=False,
                         tie_word_embeddings=True, num_attention_heads=8,
                         num_key_value_heads=1, head_dim=32),
}


def _jitter(tree, rng):
    """Random norm weights and biases over the JAX package's ones and
    zeros, so they are read and written for real."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key in ("weight", "bias") and np.asarray(node).ndim == 1:
            a = np.asarray(node, np.float32)
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return node
    return walk(tree)


def _remote_state_dict(d):
    """An HF-layout float state dict for a remote-code family: JAX's seeded
    weights (q/k/v fused where the layout stores them fused), written by
    JAX's ``state_dict_from_params``."""
    jcfg = JaxConfig.from_hf_dict(d)
    tree = _jitter(jhf.init_random_params(jcfg, seed=3),
                   np.random.default_rng(4))
    if "self_attn.q_proj" not in jhf.get_layout(jcfg.model_type).linears:
        nh, nkv, hd = (jcfg.num_attention_heads, jcfg.num_key_value_heads,
                       jcfg.head_dim_)
        for lp in tree["layers"]:
            a = lp["self_attn"]
            a["qkv_proj"] = jfuse._fuse(
                [a.pop("q_proj"), a.pop("k_proj"), a.pop("v_proj")],
                [nh * hd, nkv * hd, nkv * hd])
    return jhf.state_dict_from_params(jcfg, tree,
                                      jhf.role_out_features(jcfg),
                                      dtype=np.float32)


def _synth_state_dict(name):
    """An AutoAWQ GEMM state dict of a synthetic arch, written by JAX."""
    d = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, max_position_embeddings=64,
             **SYNTH_ARCHS[name])
    jcfg = JaxConfig(**d)
    tree = _np(jax_synth(jcfg, seed=0, group_size=64, fused=True,
                         fp_dtype="float32"))
    sd = jhf.state_dict_from_params(jcfg, tree, jhf.role_out_features(jcfg),
                                    dtype=np.float32)
    return jcfg.to_hf_dict(), sd


def _case(name):
    """(HF config dict, float numpy state dict) of a layout case."""
    if name in REMOTE_CASES:
        d = REMOTE_CASES[name]
        return d, _remote_state_dict(d)
    if name in SYNTH_ARCHS:
        return _synth_state_dict(name)
    hf_cfg, cls = _hf(name)
    torch.manual_seed(0)
    model = cls(hf_cfg).eval()
    sd = {k: v.float().numpy() for k, v in model.state_dict().items()}
    return hf_cfg.to_dict(), sd


@pytest.mark.parametrize(
    "name", HF_CASES + sorted(REMOTE_CASES) + sorted(SYNTH_ARCHS))
def test_layouts_and_forward_equal_jax(name):
    d, sd = _case(name)
    jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    modules.check_supported(cfg)
    jp = jhf.params_from_state_dict(jcfg, sd)
    pp = hf.params_from_state_dict(
        cfg, {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in sd.items()}, device="cpu")
    assert_trees_equal(pp, from_jax_params(cfg, _np(jp)))

    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    ref = jm.forward(jcfg, _jnp(jp), jnp.asarray(ids), method="jnp",
                     dtype=jnp.float32)
    got = modules.forward(cfg, pp, torch.from_numpy(ids), method="plain",
                          dtype=torch.float32)
    close(got.numpy(), ref)

    jsd = jhf.state_dict_from_params(jcfg, jp, jhf.role_out_features(jcfg))
    psd = hf.state_dict_from_params(cfg, pp, hf.role_out_features(cfg))
    assert psd.keys() == jsd.keys()
    for k in jsd:
        assert np.array_equal(psd[k].numpy(), np.asarray(jsd[k])), k
        assert psd[k].numpy().dtype == np.asarray(jsd[k]).dtype, k


# --------------------------------------------------------------------------
# (b) quantized synth trees: generate, the slot pool and the paged engine
# --------------------------------------------------------------------------

ZOO = {
    "mpt": dict(model_type="mpt", pos_embed="alibi", hidden_act="gelu",
                norm_kind="ln", gated_mlp=False, tie_word_embeddings=True,
                num_attention_heads=4, num_key_value_heads=4, head_dim=32),
    "falcon": SYNTH_ARCHS["synth_falcon"],
    "gptj": dict(model_type="gptj", hidden_act="gelu_new", norm_kind="ln",
                 rope_style="gptj", partial_rotary_factor=0.25,
                 parallel_residual=True, shared_input_norm=True,
                 gated_mlp=False, num_attention_heads=4,
                 num_key_value_heads=4, head_dim=32),
    "gemma2": dict(model_type="gemma2", norm_offset=True, embed_scale=11.3,
                   post_norms=True, logit_softcap=30.0, attn_softcap=50.0,
                   hidden_act="gelu_pytorch_tanh", attn_scale=32 ** -0.5,
                   sliding_window=16, tie_word_embeddings=True,
                   num_attention_heads=4, num_key_value_heads=2,
                   head_dim=32),
    "qwen3": dict(model_type="qwen3", qk_norm=True, rope_theta=1e6,
                  num_attention_heads=4, num_key_value_heads=2,
                  head_dim=32),
    "opt": dict(model_type="opt", hidden_act="relu", norm_kind="ln",
                pos_embed="learned", learned_pos_offset=2, gated_mlp=False,
                tie_word_embeddings=True, num_attention_heads=4,
                num_key_value_heads=4, head_dim=32),
    "bloom": dict(model_type="bloom", hidden_act="gelu", norm_kind="ln",
                  pos_embed="alibi", gated_mlp=False, embed_ln=True,
                  tie_word_embeddings=True, num_attention_heads=4,
                  num_key_value_heads=4, head_dim=32),
    "cohere": dict(model_type="cohere", norm_kind="ln", rope_style="gptj",
                   parallel_residual=True, shared_input_norm=True,
                   logit_scale=0.0625, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=32),
}
ENGINE_FAMILIES = ("mpt", "opt", "gemma2")


def _add_ffn_norms(cfg, tree):
    """gemma2's feed-forward norms, which JAX's synthesiser does not emit
    (the port's emits them as ones, as it does every norm)."""
    if cfg.post_norms:
        for lp in tree["layers"]:
            for k in ("pre_feedforward_layernorm",
                      "post_feedforward_layernorm"):
                lp.setdefault(k, {"weight": np.ones(128, np.float32)})


def _synth_models(name, vocab=128):
    kw = dict(vocab_size=vocab, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, max_position_embeddings=128, **ZOO[name])
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    tree = _np(jax_synth(jcfg, seed=0, group_size=64,
                         fused=name in ("mpt", "bloom", "falcon"),
                         fp_dtype="float32"))
    rng = np.random.default_rng(5)
    if cfg.pos_embed == "learned":  # JAX's synthesiser emits neither
        tree["embed_positions"] = {"weight": (rng.standard_normal(
            (cfg.max_position_embeddings + 2, 128)) * 0.02).astype(
                np.float32)}
    if cfg.embed_ln:
        tree["embed_ln"] = {"weight": np.ones(128, np.float32),
                            "bias": np.zeros(128, np.float32)}
    _add_ffn_norms(cfg, tree)
    tree = _jitter(tree, rng)
    return jcfg, _jnp(tree), cfg, from_jax_params(cfg, tree)


@pytest.fixture(scope="module", params=sorted(ZOO))
def zoo_model(request):
    return (request.param,) + _synth_models(request.param)


def test_generate_streams_equal_jax(zoo_model):
    name, jcfg, jp, cfg, pp = zoo_model
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 20))
    ref = jgen.generate(jcfg, jp, jnp.asarray(prompt), 10, method="jnp",
                        dtype=jnp.float32)
    got = gen.generate(cfg, pp, torch.from_numpy(prompt), 10,
                       dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _prompts(vocab, lens=(5, 11, 3, 20)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (n,)) for n in lens]


def _run(engines, vocab, n_new=8):
    outs = []
    for e in engines:
        for i, p in enumerate(_prompts(vocab)):
            e.add_request(i, p, max_new_tokens=n_new)
        outs.append(e.run())
    return outs


@pytest.mark.parametrize("name", ENGINE_FAMILIES)
def test_slot_pool_streams_equal_jax(name):
    """Per-slot ALiBi, learned positions and windows in the slot pool."""
    jcfg, jp, cfg, pp = _synth_models(name)
    kw = dict(max_batch=2, max_seq_len=40)
    je = jbatch.BatchingEngine(jcfg, jp, method="jnp", dtype=jnp.float32,
                               **kw)
    pe = batching.BatchingEngine(cfg, pp, dtype=torch.float32, device="cpu",
                                 **kw)
    ref, got = _run((je, pe), cfg.vocab_size)
    assert got == ref


@pytest.mark.parametrize("route", ["bespoke", "gather"])
@pytest.mark.parametrize("name", ENGINE_FAMILIES)
def test_paged_streams_equal_jax(name, route):
    """ALiBi slopes into K7's twin (and the gather's bias), learned
    positions per slot, the softcap and window through both routes."""
    jcfg, jp, cfg, pp = _synth_models(name)
    kw = dict(max_batch=2, page_size=8, total_pages=32, pages_per_seq=5)
    je = jpaged.PagedBatchingEngine(jcfg, jp, method="jnp",
                                    dtype=jnp.float32, **kw)
    pe = paged.PagedBatchingEngine(cfg, pp, dtype=torch.float32,
                                   device="cpu", paged_attn=route, **kw)
    ref, got = _run((je, pe), cfg.vocab_size)
    assert got == ref


def test_stock_route_refuses_alibi():
    """K9 keeps refusing an ALiBi pool (JAX falls to the gather)."""
    _, _, cfg, pp = _synth_models("mpt")
    pe = paged.PagedBatchingEngine(cfg, pp, dtype=torch.float32,
                                   device="cpu", paged_attn="stock",
                                   max_batch=2, page_size=8, total_pages=16,
                                   pages_per_seq=4)
    pe.add_request(0, np.arange(5), max_new_tokens=3)
    with pytest.raises(ValueError, match="ALiBi"):
        pe.run()


# --------------------------------------------------------------------------
# (c) rope tables and ALiBi slopes
# --------------------------------------------------------------------------

_LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2)
ROPE = {
    "default": dict(max_position_embeddings=64),
    "linear": dict(max_position_embeddings=64,
                   rope_scaling={"rope_type": "linear", "factor": 4.0}),
    "dynamic": dict(max_position_embeddings=8,
                    rope_scaling={"rope_type": "dynamic", "factor": 4.0}),
    "yarn": dict(max_position_embeddings=64, rope_scaling={
        "rope_type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 8}),
    "yarn_mscale": dict(max_position_embeddings=64, rope_scaling={
        "rope_type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 8, "mscale": 0.707,
        "mscale_all_dim": 0.707, "beta_fast": 32, "beta_slow": 1}),
    "longrope": dict(model_type="phi3", max_position_embeddings=64,
                     original_max_position_embeddings=8, rope_scaling={
                         "type": "longrope",
                         "short_factor": [1.0 + 0.25 * i for i in range(8)],
                         "long_factor": [1.0 + 0.5 * i for i in range(8)]}),
    "llama3": dict(max_position_embeddings=64, rope_scaling={
        "rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 8}),
}


@pytest.mark.parametrize("flavour", sorted(ROPE))
def test_rope_params_equal_jax(flavour):
    d = dict(dict(model_type="llama", **_LLAMA), **ROPE[flavour])
    jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
    for seq_len in (None, 4, 8, 24, 200):  # both sides of the original
        ji, js = jm.rope_params(jcfg, seq_len)
        pi, ps = modules.rope_params(cfg, seq_len)
        np.testing.assert_array_equal(pi, ji)
        assert ps == js
        pos = torch.arange(seq_len or 16)[None]
        jc, jsn = jm.rope_tables(jcfg, jnp.asarray(pos.numpy()), seq_len)
        pc, psn = modules.rope_tables(cfg, pos, seq_len)
        close(pc.numpy(), jc, 1e-6)
        close(psn.numpy(), jsn, 1e-6)


def test_rope_table_is_keyed_on_the_context():
    """A dynamic-NTK or longrope table built for one context is never
    served for another (the port caches tables per device)."""
    for flavour in ("dynamic", "longrope"):
        d = dict(dict(model_type="llama", **_LLAMA), **ROPE[flavour])
        cfg = ModelConfig.from_hf_dict(d)
        pos = torch.arange(4)[None]
        short = modules.rope_tables(cfg, pos, 4)[0]
        long = modules.rope_tables(cfg, pos, 200)[0]
        assert not torch.equal(short, long)
        assert torch.equal(modules.rope_tables(cfg, pos, 4)[0], short)


@pytest.mark.parametrize("nh", [12, 32])
def test_alibi_slopes_equal_jax(nh):
    ref = np.asarray(jm.alibi_slopes(nh))
    got = modules.alibi_slopes(nh).numpy()
    # the port's slopes are correctly rounded; XLA's f32 pow drifts up to
    # 6 ulps at 32 heads (its 2^-2 reads 0.25000003)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    q, k = torch.arange(5), torch.arange(9)
    close(modules.alibi_bias(nh, q, k).numpy(),
          jm.alibi_bias(nh, jnp.arange(5), jnp.arange(9)), 1e-6)


# --------------------------------------------------------------------------
# (d) JAX-written AutoAWQ checkpoints
# --------------------------------------------------------------------------

CKPT = {
    "mpt": ZOO["mpt"],
    "gemma2": ZOO["gemma2"],
    "gptj": dict(ZOO["gptj"], lm_head_bias=True),
    "bloom": ZOO["bloom"],
    "falcon": dict(model_type="falcon", hidden_act="gelu", norm_kind="ln",
                   parallel_residual=True, shared_input_norm=False,
                   gated_mlp=False, tie_word_embeddings=True,
                   num_attention_heads=8, num_key_value_heads=2,
                   head_dim=32),
}


@pytest.mark.parametrize("name", sorted(CKPT))
def test_jax_checkpoint_loads_with_jax_logits(tmp_path, name):
    kw = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
              num_hidden_layers=2, max_position_embeddings=64, **CKPT[name])
    jcfg = JaxConfig(**kw)
    fused = "self_attn.q_proj" not in jhf.get_layout(name).linears
    tree = _np(jax_synth(jcfg, seed=0, group_size=64, fused=fused,
                         fp_dtype="float32"))
    rng = np.random.default_rng(6)
    if jcfg.embed_ln:
        tree["embed_ln"] = {"weight": np.ones(128, np.float32),
                            "bias": np.zeros(128, np.float32)}
    if jcfg.lm_head_bias:  # gptj: an untied head with its bias
        tree["lm_head"] = {
            "kernel": (rng.standard_normal((128, 128)) * 0.02).astype(
                np.float32),
            "bias": (rng.standard_normal(128) * 0.1).astype(np.float32)}
    _add_ffn_norms(jcfg, tree)
    tree = _jitter(tree, rng)
    jser.save_quantized(str(tmp_path), jcfg,
                        JaxAwqConfig(q_group_size=64, zero_point=True),
                        tree)
    jcfg2, _, jp = jser.from_quantized(str(tmp_path))
    cfg, qcfg, pp = serialize.from_quantized(str(tmp_path), device="cpu")
    assert qcfg.q_group_size == 64
    assert_trees_equal(pp, from_jax_params(cfg, _np(jp)))
    ids = np.random.default_rng(7).integers(0, 128, (B, S))
    ref = jm.forward(jcfg2, _jnp(jp), jnp.asarray(ids), method="jnp",
                     dtype=jnp.float32)
    got = modules.forward(cfg, pp, torch.from_numpy(ids), method="plain",
                          dtype=torch.float32)
    close(got.numpy(), ref)


def test_k_the_jax_loader_pads_loads_unpadded(tmp_path):
    """A K the JAX loader zero-pads (above two groups and not a multiple of
    twice the group, as falcon-7b's 4544 at g64) loads in the port as it
    is, with JAX's logits: the port's kernels take any K its group size
    divides, so it needs no pad."""
    kw = dict(model_type="falcon", vocab_size=128, hidden_size=320,
              intermediate_size=256, num_hidden_layers=1,
              max_position_embeddings=64, **{
                  k: v for k, v in CKPT["falcon"].items()
                  if k != "model_type"})
    jcfg = JaxConfig(**kw)
    tree = _np(jax_synth(jcfg, seed=0, group_size=64, fused=True,
                         fp_dtype="float32"))
    jser.save_quantized(str(tmp_path), jcfg,
                        JaxAwqConfig(q_group_size=64, zero_point=True), tree)
    jcfg2, _, jp = jser.from_quantized(str(tmp_path))
    cfg, _, pp = serialize.from_quantized(str(tmp_path), device="cpu")
    fc1 = pp["layers"][0]["mlp"]["fc1"]
    assert 8 * fc1["qweight"].shape[0] == 320  # JAX's holds 384 rows
    ids = np.random.default_rng(8).integers(0, 128, (B, S))
    ref = jm.forward(jcfg2, _jnp(jp), jnp.asarray(ids), method="jnp",
                     dtype=jnp.float32)
    got = modules.forward(cfg, pp, torch.from_numpy(ids), method="plain",
                          dtype=torch.float32)
    close(got.numpy(), ref)
