"""Flat tensor parallelism of the trees the port used to refuse, on the CPU,
in one gloo world of two ranks (``tests/torch_parallel_ranks.py``), against
the JAX package on its 8 virtual CPU devices: an ALiBi MPT (each rank's
slopes), an MLA + MoE DeepSeek-V2 (whole heads a rank, the absorbed latent
decode on the local heads with the replicated latent cache, shared experts
at ``tp_div`` 2), and a LoRA tree (``lora_train_step`` on the rank's
shards; the adapters' gradients through Megatron's conjugate pair).

Inputs are JAX's seeded trees carried into the port by
``convert.from_jax_params``. Tolerances: f32 logits rtol = atol = 2e-4
(``tests/test_parallel.py``'s: only the order of the sums differs), decode
logits 2e-3 (``tests/test_tp_attn.py``'s), the LoRA loss, updates and
gradients 1e-4 (``tests/test_pipeline.py``'s tensor-parallel step)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from autoawq_tpu.io.hf import init_random_params as jax_init
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.nn.fuse import fuse_model as jax_fuse
from autoawq_tpu.parallel.mesh import build_mesh as jax_mesh
from autoawq_tpu.parallel.specs import shard_params as jshard
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.train import lora as jlora
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig

# an MPT-7B-shaped block at small width (MHA, ALiBi, LayerNorm, gelu fc1 /
# fc2, the natively fused qkv)
MPT = dict(model_type="mpt", vocab_size=128, hidden_size=256,
           intermediate_size=1024, num_hidden_layers=2,
           num_attention_heads=8, num_key_value_heads=8, head_dim=32,
           max_position_embeddings=64, hidden_act="gelu", norm_kind="ln",
           pos_embed="alibi", gated_mlp=False, tie_word_embeddings=True)
# tests/test_pipeline.py's DeepSeek (MLA, 4 stacked experts, 2 shared)
MLA = dict(model_type="deepseek_v2", vocab_size=128, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=16, num_key_value_heads=16, q_lora_rank=256,
           kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=64,
           v_head_dim=64, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=1024, n_shared_experts=2,
           max_position_embeddings=64)
# tests/test_pipeline.py's PP x TP LoRA model and targets
LORA = dict(model_type="llama", vocab_size=256, hidden_size=128,
            intermediate_size=256, num_hidden_layers=4,
            num_attention_heads=4, num_key_value_heads=2, head_dim=32,
            max_position_embeddings=64)
TARGETS = ("q_proj", "v_proj", "o_proj", "down_proj")
TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return jax_mesh(tensor=2, data=jax.device_count() // 2)


def _jax_runs(d, tree, tokens, prompt):
    """JAX's forward on its shard_params tree, and its prefill plus one
    decode step (f32) on the sharded tree, jitted on the mesh."""
    cfg = JaxConfig(**d)
    mesh = _mesh()
    with mesh:
        sharded = jshard(tree, mesh, dtype=jnp.float32)
        fwd = np.asarray(jax.jit(lambda p, x: jm.forward(
            cfg, p, x, method="jnp"))(sharded, jnp.asarray(tokens)))

        def decode(p, x):
            caches = jgen.init_kv_cache(cfg, x.shape[0], 64, jnp.float32)
            logits, caches = jgen.prefill(cfg, p, x, caches, "jnp",
                                          jnp.float32)
            tok = jnp.argmax(logits, -1)[:, None]
            out, _ = jgen.decode_step(cfg, p, tok, caches,
                                      jnp.int32(x.shape[1]), "jnp",
                                      jnp.float32)
            return out

        dec = np.asarray(jax.jit(decode)(sharded, jnp.asarray(prompt)))
    return fwd, dec


def _paths(tree, prefix=""):
    out = {}
    for k, v in (enumerate(tree) if isinstance(tree, list) else
                 tree.items()):
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_paths(v, path))
        elif str(k).startswith("lora_"):
            out[path] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    mpt = _np(jax_synth(JaxConfig(**MPT), seed=4, group_size=64,
                        fp_dtype=jnp.float32, fused=True))
    mla_cfg = JaxConfig(**MLA)
    mla = _np(jax_fuse(mla_cfg, jax_synth(mla_cfg, seed=13,
                                          fp_dtype=jnp.float32)))
    lcfg = JaxConfig(**LORA)
    lora_tree = _np(jlora.add_lora(
        lcfg, jax_init(lcfg, seed=5, scale=0.08), rank=4, targets=TARGETS,
        dtype=jnp.float32))
    toks = {n: rng.integers(0, 128, (2, 16)) for n in ("mpt", "mla")}
    prompts = {n: rng.integers(0, 128, (2, 12)) for n in ("mpt", "mla")}
    lora_tokens = rng.integers(0, 256, (4, 16))
    t = torch.from_numpy
    inputs = {"lora_cfg": ModelConfig(**LORA),
              "lora_params": from_jax_params(ModelConfig(**LORA), lora_tree),
              "lora_tokens": t(lora_tokens)}
    for name, d, tree in (("mpt", MPT, mpt), ("mla", MLA, mla)):
        cfg = ModelConfig(**d)
        inputs.update({f"{name}_cfg": cfg,
                       f"{name}_params": from_jax_params(cfg, tree),
                       f"{name}_tokens": t(toks[name]),
                       f"{name}_prompt": t(prompts[name])})
    world = ranks.start_world(2, ["tp_breadth"], inputs)

    ref = {"mpt": _jax_runs(MPT, mpt, toks["mpt"], prompts["mpt"]),
           "mla": _jax_runs(MLA, mla, toks["mla"], prompts["mla"])}
    lora, base = jlora.split_lora(lora_tree)
    tk = jnp.asarray(lora_tokens)
    loss, grads = jax.value_and_grad(lambda l: jlora.causal_lm_loss(
        lcfg, jlora.merge_lora(l, base), tk))(lora)
    ref["lora_loss"] = float(loss)
    ref["lora_grads"] = _paths(_np(grads))
    ref["lora_new"] = _paths(_np(jlora.lora_train_step(
        lcfg, lora, base, tk, lr=1e-2)[1]))
    return ref, world.results()


def _same(res, key):
    first = res[0]["tp_breadth"][key]
    for r in res[1:]:
        assert torch.equal(r["tp_breadth"][key], first), key
    return first.numpy()


@pytest.mark.parametrize("name", ["mpt", "mla"])
def test_flat_tp_forward_equals_jax_sharded(run, name):
    """The tensor-2 forward of an ALiBi MPT (each rank the slopes of its 4
    of 8 heads) and an MLA + MoE DeepSeek (8 of 16 heads a rank, shared
    experts split) against JAX's forward on its shard_params tree."""
    ref, res = run
    np.testing.assert_allclose(_same(res, (name, "forward")), ref[name][0],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["mpt", "mla"])
def test_flat_tp_decode_step_equals_jax_sharded(run, name):
    """A prefill and one decode step at tensor 2 (MPT: the ALiBi bias of
    the rank's heads against the cache; DeepSeek: the absorbed latent
    decode on the rank's heads, kv_b's dense leaf built from its slice,
    the whole latent cache on every rank) against JAX's on its mesh."""
    ref, res = run
    np.testing.assert_allclose(_same(res, (name, "decode")), ref[name][1],
                               rtol=2e-3, atol=2e-3)


def test_rank_configs_name_their_heads(run):
    """Each rank's config holds nh / 2 heads and its offset in the global
    sheet (``RankConfig``)."""
    _, res = run
    for rank, r in enumerate(res):
        assert r["tp_breadth"][("mpt", "cfg")] == (4, 4 * rank)
        assert r["tp_breadth"][("mla", "cfg")] == (8, 8 * rank)


def _whole(res, key):
    """The ranks' adapter leaves as whole leaves: q / v columns' lora_b and
    o / down rows' lora_a concatenated, the replicated halves equal on
    both ranks."""
    out = {}
    for path in res[0]["tp_breadth"][key] if key == "lora_grads" else \
            res[0]["tp_breadth"][key]["adapters"]:
        parts = [(r["tp_breadth"][key] if key == "lora_grads" else
                  r["tp_breadth"][key]["adapters"])[path] for r in res]
        lin, leaf = path.split(".")[-2:]
        row = lin in ("o_proj", "down_proj")
        if (leaf == "lora_a") == row:
            out[path] = torch.cat(parts, dim=0 if row else 1).numpy()
        else:
            assert torch.equal(parts[0], parts[1]), path
            out[path] = parts[0].numpy()
    return out


def test_flat_tp_lora_gradients_equal_jax(run):
    """Every adapter's gradient at tensor 2 equals JAX's on the unsharded
    tree: the replicated halves (q / v's lora_a, o / down's lora_b) only
    because Megatron's conjugate pair sums their ranks' parts, and the
    residual stream's gradient only because f sums it before a column
    shard (a plain all-reduce, which has no backward, gets both wrong)."""
    ref, res = run
    got = _whole(res, "lora_grads")
    assert set(got) == set(ref["lora_grads"])
    for path, g in got.items():
        np.testing.assert_allclose(g, ref["lora_grads"][path], rtol=1e-4,
                                   atol=1e-4, err_msg=path)


def test_flat_tp_lora_train_step_equals_jax(run):
    """``lora_train_step`` on the rank's shards of a LoRA tree: the loss
    and the updated adapters equal JAX's step on the unsharded tree."""
    ref, res = run
    for r in res:
        assert abs(r["tp_breadth"]["lora_step"]["loss"]
                   - ref["lora_loss"]) < 1e-4
    got = _whole(res, "lora_step")
    assert set(got) == set(ref["lora_new"])
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf, ref["lora_new"][path], rtol=1e-4,
                                   atol=1e-4, err_msg=path)


def test_conjugate_pair_and_gather_gradients(run):
    """Each autograd collective's gradient on each rank at tensor 2
    (``parallel/distributed``): a gathered input's piece gets its slice of
    the whole gradient, f gives a replicated input the sum of the ranks'
    column parts, g sums the row partials and passes the gradient to each
    unchanged; all against one process's autograd on the whole product."""
    _, res = run
    for rank, r in enumerate(res):
        p = r["tp_breadth"]["pair"]
        x, w, c = p["x"], p["w"], p["c"]
        whole = c @ w.T  # d/dx of sum((x @ w) * c)
        rows = slice(4 * rank, 4 * rank + 4)
        torch.testing.assert_close(p["gather"], whole[:, rows])
        torch.testing.assert_close(p["copy"], whole)
        torch.testing.assert_close(p["reduce"], whole[:, rows])
        torch.testing.assert_close(p["reduce_y"], x @ w)
