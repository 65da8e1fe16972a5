"""Sequence parallelism and the pipelined LoRA step over MLA and MoE stages
in the port on the CPU, in one gloo world of four ranks
(``tests/torch_parallel_ranks.py``), against the JAX package on its 8
virtual CPU devices.

(e) ``nn/modules.forward(..., sequence_parallel=mesh.axis("tensor"))`` at
tensor 4 against JAX's ``forward(activation_spec=P("data", "tensor",
None))`` at tensor 4 x data 2 (the data axis only splits the batch, so the
port's world holds data 1): ``tests/test_pipeline.py``'s config (hidden
256, inter 4096, 2 layers, 8 / 4 heads of 32, tokens [2, 32]), the same at
S = 30 (padded to 32 and cut back), a Mixtral MoE (its expert lists
replicate, so its blocks slice their output) and a DeepSeek-V2 MLA with a
dense first layer, where JAX's GSPMD forward runs both. Logits within JAX's
own tolerance (rtol = atol = 2e-4); the SP logits within 1e-5 of their
scale of the same ranks' replicated tensor-parallel forward (f32 sums in
another order); every rank's logits equal; one reduce-scatter a block
whose MLP ends in a row shard, none where the output is replicated. Also
a GPT-J-style parallel residual at S = 30, whose attention and MLP row
shards are summed and reduce-scattered once a block.
(f) ``pipeline_lora_step`` at pipe 2 x tensor 2: on MLA stages (dense
MLPs, adapters on q_b, kv_b and o) the loss within 1e-4 and every updated
adapter within 1e-4 of JAX's (``tests/test_torch_pipeline.py``'s rule);
on MoE stages, whose experts split over tensor, JAX's step raises
NotImplementedError at the grouped kernel, and so does the port's, on
every rank, before any transfer.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.parallel import pipeline as jpp
from autoawq_tpu.parallel.mesh import build_mesh as jax_mesh
from autoawq_tpu.parallel.specs import shard_params as jax_shard
from autoawq_tpu.train import lora as jlora
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from test_torch_pipeline import MOE, _assemble, _get, _jax_lora, _lins

# tests/test_pipeline.py::test_sequence_parallel_forward_matches
SP_LLAMA = dict(model_type="llama", vocab_size=512, hidden_size=256,
                intermediate_size=4096, num_hidden_layers=2,
                num_attention_heads=8, num_key_value_heads=4, head_dim=32,
                max_position_embeddings=64)
SP_MOE = dict(model_type="mixtral", vocab_size=512, hidden_size=256,
              intermediate_size=1024, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=4, head_dim=32,
              num_local_experts=4, num_experts_per_tok=2,
              max_position_embeddings=64)
SP_MLA = dict(model_type="deepseek_v2", vocab_size=512, hidden_size=256,
              intermediate_size=4096, num_hidden_layers=2,
              num_attention_heads=8, num_key_value_heads=8,
              q_lora_rank=None, kv_lora_rank=128, qk_nope_head_dim=32,
              qk_rope_head_dim=32, v_head_dim=32, n_routed_experts=4,
              num_experts_per_tok=2, moe_intermediate_size=256,
              n_shared_experts=2, first_k_dense_replace=1,
              max_position_embeddings=64)
# a parallel residual (attention and MLP off one input; LayerNorms,
# partial rotary, fc1 / fc2): its two branches' row shards reduce once
SP_GPTJ = dict(model_type="gptj", n_embd=512, n_layer=2, n_head=8,
               rotary_dim=32, n_inner=None, vocab_size=512, n_positions=64,
               activation_function="gelu_new", layer_norm_epsilon=1e-5,
               tie_word_embeddings=False)
SP_CASES = {"llama": (SP_LLAMA, 32), "llama_uneven": (SP_LLAMA, 30),
            "moe": (SP_MOE, 32), "mla": (SP_MLA, 30),
            "parallel_residual": (SP_GPTJ, 30)}
# scatters a forward makes: one a block whose MLP ends in a row shard
# (an MoE model's MLPs, its dense first layer's too, replicate under flat
# tensor parallelism, as JAX's ``_local_cfg`` keeps their widths)
SCATTERS = {"llama": 2, "llama_uneven": 2, "moe": 0, "mla": 0,
            "parallel_residual": 2}
# an MLA model with dense MLPs (JAX's PP x TP granularity: inter 2048)
PP_MLA = dict(model_type="minicpm3", vocab_size=128, hidden_size=256,
              intermediate_size=2048, num_hidden_layers=2,
              num_attention_heads=16, num_key_value_heads=16,
              q_lora_rank=256, kv_lora_rank=256, qk_nope_head_dim=64,
              qk_rope_head_dim=64, v_head_dim=64,
              max_position_embeddings=32)
TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _quant(cfg, seed, fuse=False):
    tree = jax_synth(cfg, seed=seed, fp_dtype=jnp.float32)
    if fuse:
        from autoawq_tpu.nn.fuse import fuse_model

        tree = fuse_model(cfg, tree)
    return _np(tree)


def _jax_sp(cfg, tree, tokens):
    mesh = jax_mesh(tensor=4, data=2)
    with mesh:
        sharded = jax_shard(jax.tree_util.tree_map(jnp.asarray, tree), mesh,
                            dtype=jnp.float32)
        tk = jax.device_put(jnp.asarray(tokens),
                            NamedSharding(mesh, P("data", None)))
        sp = NamedSharding(mesh, P("data", "tensor", None))
        return np.asarray(jax.jit(lambda p, t: jm.forward(
            cfg, p, t, method="jnp", activation_spec=sp))(sharded, tk))


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    sp_in, sp_ref = {}, {}
    jax_side = []
    for name, (d, s) in SP_CASES.items():
        jcfg, cfg = JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)
        tree = _quant(jcfg, seed=1)
        tokens = rng.integers(0, 512, (2, s))
        sp_in[name] = {"cfg": cfg, "params": from_jax_params(cfg, tree),
                       "tokens": torch.from_numpy(tokens)}
        jax_side.append((name, jcfg, tree, tokens))
    mla_j = JaxConfig(**PP_MLA)
    mla_tree = _np(jlora.add_lora(
        mla_j, jax_synth(mla_j, seed=2, fp_dtype=jnp.float32), rank=4,
        targets=("q_b_proj", "kv_b_proj", "o_proj")))
    mla_cfg = ModelConfig(**PP_MLA)
    mla_tokens = rng.integers(0, 128, (4, 8))
    moe_j = JaxConfig(**MOE)
    moe_tree = _np(jlora.add_lora(
        moe_j, _quant(moe_j, seed=11, fuse=True), rank=4,
        targets=("q_proj", "o_proj")))
    moe_cfg = ModelConfig(**MOE)
    moe_tokens = rng.integers(0, 128, (4, 8))
    inputs = {
        "sp": sp_in,
        "pp_mla": {"cfg": mla_cfg, "params": from_jax_params(mla_cfg,
                                                             mla_tree),
                   "tokens": torch.from_numpy(mla_tokens)},
        "pp_moe": {"cfg": moe_cfg, "params": from_jax_params(moe_cfg,
                                                             moe_tree),
                   "tokens": torch.from_numpy(moe_tokens)}}
    world = ranks.start_world(4, ["sp_forward", "pp_mla_lora",
                                  "pp_moe_refusal"], inputs, timeout=300.0)
    for name, jcfg, tree, tokens in jax_side:
        sp_ref[name] = _jax_sp(jcfg, tree, tokens)
    ref = {"sp": sp_ref,
           "mla_lora": _jax_lora(PP_MLA, mla_tree, mla_tokens,
                                 jax_mesh(pipe=2, tensor=2, data=2,
                                          devices=jax.devices()[:8]))}
    try:
        pparams = jpp.to_pipeline(moe_j, copy.deepcopy(moe_tree),
                                  jax_mesh(pipe=2, tensor=2, data=2,
                                           devices=jax.devices()[:8]))
        mesh = jax_mesh(pipe=2, tensor=2, data=2, devices=jax.devices()[:8])
        lo, base = jlora.split_lora(pparams)
        with mesh:
            jax.jit(lambda l, b, t: jpp.pipeline_lora_step(
                moe_j, l, b, t, mesh, 2, lr=1e-2))(lo, base,
                                                   jnp.asarray(moe_tokens))
        ref["moe_error"] = None
    except NotImplementedError as e:
        ref["moe_error"] = type(e).__name__
    return ref, world.results()


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_sequence_parallel_forward_equals_jax(run, name):
    ref, res = run
    got = res[0]["sp_forward"][name]["sp"]
    for r in res[1:]:
        assert torch.equal(r["sp_forward"][name]["sp"], got)
    want = ref["sp"][name]
    assert got.shape == want.shape == (2, SP_CASES[name][1], 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    tp = res[0]["sp_forward"][name]["tp"]
    np.testing.assert_allclose(got.numpy(), tp.numpy(), rtol=0,
                               atol=1e-5 * float(tp.abs().max()))
    scatters = res[0]["sp_forward"][name]["scatters"]
    assert len(scatters) == SCATTERS[name]
    for shape in scatters:  # [B, S padded to a multiple of 4, H]
        assert shape[1] % 4 == 0 and shape[1] >= SP_CASES[name][1]


def test_pipeline_lora_step_on_mla_stages_equals_jax(run):
    ref, res = run
    loss, layers = ref["mla_lora"]
    for r in res:
        assert abs(r["pp_mla_lora"]["loss"] - loss) < 1e-4
    whole = _assemble([{"pp_lora": {"mla": r["pp_mla_lora"]}} for r in res],
                      "mla", len(layers), len(layers) // 2)
    assert len(whole) == sum(2 * len(_lins(lp)) for lp in layers) == 12
    for (li, path), leaf in whole.items():
        np.testing.assert_allclose(leaf.numpy(), _get(layers[li], path),
                                   rtol=1e-4, atol=1e-4, err_msg=path)


def test_pipeline_lora_step_on_expert_split_stages_raises_as_jax(run):
    ref, res = run
    assert ref["moe_error"] == "NotImplementedError"
    for r in res:
        assert r["pp_moe_refusal"] is not None
        assert "tp_ep" in r["pp_moe_refusal"]
