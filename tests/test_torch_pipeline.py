"""Pipeline parallelism of the port on the CPU (``parallel/pipeline.py``),
in one gloo world of four ranks (``tests/torch_parallel_ranks.py``),
against the JAX package's own ``parallel/pipeline.py`` on its 8 virtual
CPU devices: each case of ``tests/test_pipeline.py``. The forward at pipe
2 x data 2 and at pipe 4 over 1, 2 and 4 microbatches; the LoRA step at
pipe 2 x data 2; pipe 2 x tensor 2 (dense, quantized, the LoRA step,
stacked MoE with a shared expert, MLA DeepSeek, ALiBi, a fused checkpoint
split back into its members); the refusals; ``stack_layers`` /
``unstack_layers``; the meshes.

Inputs are JAX's seeded trees carried into the port by
``convert.from_jax_params`` (adapters included). Tolerances are JAX's own
(``tests/test_pipeline.py``): logits rtol = atol = 2e-4, the microbatch
counts 1e-5 among themselves, the LoRA loss 1e-4 and its updates 1e-5 (1e-4
under tensor parallelism). The JAX meshes hold data 2 where the port's
world has data 1: the values do not depend on it."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from autoawq_tpu.io.hf import init_random_params as jax_init
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn.fuse import fuse_model as jax_fuse
from autoawq_tpu.parallel import pipeline as jpp
from autoawq_tpu.parallel.mesh import build_mesh as jax_mesh
from autoawq_tpu.train import lora as jlora
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.parallel import pipeline as pp

# tests/test_pipeline.py's models
CFG = dict(model_type="llama", vocab_size=256, hidden_size=128,
           intermediate_size=256, num_hidden_layers=8, num_attention_heads=4,
           num_key_value_heads=2, head_dim=32, max_position_embeddings=64)
TPC = dict(CFG, num_hidden_layers=4)
QUANT = dict(model_type="llama", vocab_size=128, hidden_size=2048,
             intermediate_size=2048, num_hidden_layers=2,
             num_attention_heads=16, num_key_value_heads=16, head_dim=128,
             max_position_embeddings=32)
# JAX's stacked-MoE case is a qwen2_moe, a type without a JAX loader, which
# the port refuses (modules.check_supported); qwen3_moe routes the same way
# here (softmax top-2, no renormalisation) and takes the gated shared expert
MOE = dict(model_type="qwen3_moe", vocab_size=128, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=16, num_key_value_heads=16, head_dim=128,
           num_experts=4, num_experts_per_tok=2, moe_intermediate_size=512,
           shared_expert_intermediate_size=2048, max_position_embeddings=32)
MLA = dict(model_type="deepseek_v2", vocab_size=128, hidden_size=256,
           intermediate_size=512, num_hidden_layers=2,
           num_attention_heads=16, num_key_value_heads=16, q_lora_rank=256,
           kv_lora_rank=256, qk_nope_head_dim=64, qk_rope_head_dim=64,
           v_head_dim=64, num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=1024, n_shared_experts=2,
           max_position_embeddings=32)
ALIBI = dict(model_type="bloom", vocab_size=64, hidden_size=64,
             intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=4, head_dim=16,
             max_position_embeddings=32, pos_embed="alibi")
BAD = dict(model_type="llama", vocab_size=64, hidden_size=64,
           intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
           num_key_value_heads=1, head_dim=32, max_position_embeddings=32)
MIX = dict(model_type="mixtral", vocab_size=64, hidden_size=64,
           intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, head_dim=16, num_experts=4,
           num_experts_per_tok=2, max_position_embeddings=32)
ODD = dict(CFG, num_hidden_layers=3)
TOL = 2e-4
PP_DP = dict(pipe=2, data=2)
PP_TP = dict(pipe=2, tensor=2)
CASES = ["meshes", "pp_forward", "pp_lora", "pp_refusals"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _quant(d, seed, fuse=False):
    cfg = JaxConfig(**d)
    tree = jax_synth(cfg, seed=seed, fp_dtype=jnp.float32)
    return _np(jax_fuse(cfg, tree) if fuse else tree)


def _port(d, tree):
    cfg = ModelConfig(**d)
    return cfg, from_jax_params(cfg, tree)


def _jmesh(pipe, tensor=1, data=2):
    n = pipe * tensor * data
    return jax_mesh(pipe=pipe, tensor=tensor, data=data,
                    devices=jax.devices()[:n])


def _jax_forward(d, tree, tokens, mesh, m):
    cfg = JaxConfig(**d)
    pparams = jpp.to_pipeline(cfg, copy.deepcopy(tree), mesh)
    with mesh:
        return np.asarray(jax.jit(lambda p, t: jpp.pipeline_forward(
            cfg, p, t, mesh, n_microbatches=m))(pparams, jnp.asarray(tokens)))


def _jax_lora(d, tree, tokens, mesh):
    """JAX's pipelined step: (loss, the updated adapters of each layer)."""
    cfg = JaxConfig(**d)
    pparams = jpp.to_pipeline(cfg, copy.deepcopy(tree), mesh)
    lora, base = jlora.split_lora(pparams)
    with mesh:
        loss, new = jax.jit(lambda l, b, t: jpp.pipeline_lora_step(
            cfg, l, b, t, mesh, 2, lr=1e-2))(lora, base, jnp.asarray(tokens))
    layers = jpp.unstack_layers(_np(new["layers_stacked"]),
                                cfg.num_hidden_layers)
    return float(loss), layers


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    trees = {
        "dense": (CFG, _quant(CFG, 0)),
        "tp": (TPC, _np(jax_init(JaxConfig(**TPC), seed=3, scale=0.08))),
        "quant": (QUANT, _quant(QUANT, 2)),
        "moe": (MOE, _quant(MOE, 11, fuse=True)),
        "mla": (MLA, _quant(MLA, 13, fuse=True)),
        "alibi": (ALIBI, _np(jax_init(JaxConfig(**ALIBI), seed=7,
                                      scale=0.08))),
        "fused": (QUANT, _quant(QUANT, 2, fuse=True)),
    }
    tokens = {"dense": rng.integers(0, 256, (4, 16)),
              "invariance": rng.integers(0, 256, (8, 8)),
              "tp": rng.integers(0, 256, (4, 16)),
              "quant": rng.integers(0, 128, (4, 8)),
              "moe": rng.integers(0, 128, (4, 8)),
              "mla": rng.integers(0, 128, (4, 8)),
              "alibi": rng.integers(0, 64, (4, 16)),
              "fused": rng.integers(0, 128, (4, 8))}
    lora_trees = {
        "dense": (CFG, _np(jlora.add_lora(
            JaxConfig(**CFG), jax_synth(JaxConfig(**CFG), seed=0,
                                        fp_dtype=jnp.float32),
            rank=4, dtype=jnp.float32))),
        "tp": (TPC, _np(jlora.add_lora(
            JaxConfig(**TPC), jax_init(JaxConfig(**TPC), seed=5,
                                       scale=0.08), rank=4,
            targets=("q_proj", "v_proj", "o_proj", "down_proj"),
            dtype=jnp.float32)))}
    t = torch.from_numpy
    fwd = {}
    for name, (d, tree) in trees.items():
        cfg, params = _port(d, tree)
        dense = name == "dense"
        fwd[name] = {"cfg": cfg, "params": params,
                     "tokens": t(tokens[name]),
                     "mesh": PP_DP if dense else PP_TP,
                     "microbatches": (2,)}
    cfg, params = _port(CFG, trees["dense"][1])
    fwd["invariance"] = {"cfg": cfg, "params": params,
                         "tokens": t(tokens["invariance"]),
                         "mesh": dict(pipe=4), "microbatches": (1, 2, 4)}
    lora_in = {}
    for name, (d, tree) in lora_trees.items():
        cfg, params = _port(d, tree)
        lora_in[name] = {"cfg": cfg, "params": params,
                         "tokens": t(tokens["dense" if name == "dense"
                                            else "tp"]),
                         "mesh": PP_DP if name == "dense" else PP_TP}
    refuse = {
        "heads": _port(BAD, _quant(BAD, 0)),
        "heads_fused": _port(BAD, _np(jax_synth(
            JaxConfig(**BAD), seed=0, fp_dtype=jnp.float32, fused=True))),
        "experts": _port(MIX, _np(jax_init(JaxConfig(**MIX), seed=0))),
        "layers": _port(ODD, _quant(ODD, 1)),
    }
    world = ranks.start_world(4, CASES, {"pp_forward": fwd,
                                         "pp_lora": lora_in,
                                         "pp_refuse": refuse},
                              timeout=240.0)

    ref = {}
    ref["dense"] = _jax_forward(CFG, trees["dense"][1], tokens["dense"],
                                _jmesh(2), 2)
    ref["invariance"] = _jax_forward(CFG, trees["dense"][1],
                                     tokens["invariance"], _jmesh(4), 4)
    for name in ("tp", "quant", "moe", "mla", "alibi", "fused"):
        d, tree = trees[name]
        ref[name] = _jax_forward(d, tree, tokens[name], _jmesh(2, 2), 2)
    ref["lora_dense"] = _jax_lora(CFG, lora_trees["dense"][1],
                                  tokens["dense"], _jmesh(2))
    ref["lora_tp"] = _jax_lora(TPC, lora_trees["tp"][1], tokens["tp"],
                               _jmesh(2, 2))
    return ref, world.results()


def _same_on_every_rank(res, key):
    first = res[0]["pp_forward"][key]
    for r in res[1:]:
        assert torch.equal(r["pp_forward"][key], first), key
    return first.numpy()


def test_pipeline_forward_at_pipe_2_data_2_equals_jax(run):
    """pipe 2 x data 2, 2 microbatches: every rank returns the whole
    batch's logits, JAX's ``pipeline_forward`` on the same mesh."""
    ref, res = run
    got = _same_on_every_rank(res, ("dense", 2))
    np.testing.assert_allclose(got, ref["dense"], rtol=TOL, atol=TOL)


def test_pipeline_microbatch_count_invariance(run):
    """pipe 4 over 1, 2 and 4 microbatches: the same logits (1e-5), and
    JAX's at 4 microbatches."""
    ref, res = run
    got = {m: _same_on_every_rank(res, ("invariance", m)) for m in (1, 2, 4)}
    for m in (1, 2):
        np.testing.assert_allclose(got[m], got[4], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[4], ref["invariance"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["tp", "quant", "moe", "mla", "alibi",
                                  "fused"])
def test_pipeline_tp_forward_equals_jax(run, case):
    """pipe 2 x tensor 2: Megatron shards inside every stage (float,
    quantized, stacked MoE on the tensor axis with a tp_div shared expert,
    MLA over whole heads, ALiBi on each rank's slopes, a fused checkpoint
    split into its members) against JAX's pipeline on its PP x TP mesh."""
    ref, res = run
    got = _same_on_every_rank(res, (case, 2))
    np.testing.assert_allclose(got, ref[case], rtol=TOL, atol=TOL)


def test_fused_checkpoint_is_read_not_unfused(run):
    """The port splits a fused qkv / gate_up into its members' shards
    without writing the caller's tree (JAX unfuses it in place)."""
    _, res = run
    assert all(r["pp_forward"][("fused", "fused_kept")] for r in res)


def _assemble(res, name, n_layers, per_stage):
    """The ranks' updated adapters as whole leaves by (layer, path): column
    shards' lora_b and row shards' lora_a concatenated over tensor."""
    parts = {}
    for r in res:
        out = r["pp_lora"][name]
        w = out["where"]
        if w.get("data", 0):
            continue
        for path, leaf in out["adapters"].items():
            _, i, rest = path.split(".", 2)
            li = w["pipe"] * per_stage + int(i)
            parts.setdefault((li, rest), {})[w.get("tensor", 0)] = leaf
    whole = {}
    for (li, rest), shards in parts.items():
        pieces = [shards[k] for k in sorted(shards)]
        _, lin, leaf = rest.split(".")
        row = lin in ("o_proj", "down_proj")
        if (leaf == "lora_a") == row:  # the LIN's sharded half
            whole[(li, rest)] = torch.cat(pieces, dim=0 if row else 1)
        else:  # replicated: the same on every tensor rank
            assert all(torch.equal(p, pieces[0]) for p in pieces)
            whole[(li, rest)] = pieces[0]
    assert len({li for li, _ in whole}) == n_layers
    return whole


def _get(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name,tol", [("dense", 1e-5), ("tp", 1e-4)])
def test_pipeline_lora_step_equals_jax(run, name, tol):
    """One pipelined SGD step (pipe 2 x data 2 with adapters on q / k / v /
    o; pipe 2 x tensor 2 with q / v / o / down, as JAX's PP x TP test):
    the loss on every rank within 1e-4 of JAX's, every updated adapter
    within JAX's tolerance of JAX's."""
    ref, res = run
    loss, layers = ref[f"lora_{name}"]
    for r in res:
        assert abs(r["pp_lora"][name]["loss"] - loss) < 1e-4
    n = len(layers)
    whole = _assemble(res, name, n, n // 2)
    assert len(whole) == sum(2 * len(_lins(lp)) for lp in layers)
    for (li, path), leaf in whole.items():
        np.testing.assert_allclose(leaf.numpy(), _get(layers[li], path),
                                   rtol=tol, atol=tol, err_msg=path)


def _lins(lp):
    return [(s, k) for s, sub in lp.items() if isinstance(sub, dict)
            for k, v in sub.items() if isinstance(v, dict) and "lora_a" in v]


def test_refusals_carry_jax_messages_and_leave_the_tree(run):
    """KV heads that do not divide tensor (fused or not), an unstacked
    expert list and layers that do not divide pipe raise JAX's errors
    before anything is built; the caller's tree is as it was. A batch the
    microbatches do not divide, and a microbatch the data axis does not
    divide, raise JAX's ValueErrors."""
    _, res = run
    out = res[0]["pp_refusals"]
    for name in ("heads", "heads_fused"):
        assert out[name]["error"] == (
            "ValueError", "PPxTP: heads (2/1) must divide tensor=2")
    kind, msg = out["experts"]["error"]
    assert kind == "NotImplementedError" and "experts" in msg
    assert out["layers"]["error"] == (
        "ValueError", "3 layers not divisible by pipe=2")
    assert all(v["untouched"] for k, v in out.items()
               if isinstance(v, dict))
    assert out["microbatches"] == "batch 4 % microbatches 3 != 0"
    assert out["data"].startswith(
        "microbatch size 1 not divisible by the data axis (2)")


def test_stack_layers_rejects_heterogeneous():
    lo = {"mlp": {"kernel": torch.zeros(4, 4)}}
    hi = {"mlp": {"kernel": torch.zeros(4, 4), "bias": torch.zeros(4)}}
    with pytest.raises(ValueError, match="heterogeneous"):
        pp.stack_layers([lo, hi])


def test_stack_unstack_roundtrip_equals_jax():
    """``stack_layers`` / ``unstack_layers`` round-trip a port tree bit for
    bit, and the stacked leaves are JAX's stacked leaves in the port's
    layout (a quantized LIN per layer, as ``from_jax_params`` carries
    it)."""
    tree = _quant(TPC, 0)
    cfg, params = _port(TPC, tree)
    stacked = pp.stack_layers(params["layers"])
    back = pp.unstack_layers(stacked, TPC["num_hidden_layers"])
    for orig, rec in zip(params["layers"], back):
        for sub in orig:
            for k, v in orig[sub].items():
                for leaf, t in (v.items() if isinstance(v, dict)
                                else [(None, v)]):
                    got = rec[sub][k] if leaf is None else rec[sub][k][leaf]
                    assert torch.equal(got, t)
    jstacked = jpp.stack_layers(tree["layers"])
    ja = jpp.unstack_layers(jstacked, TPC["num_hidden_layers"])
    port_again = from_jax_params(cfg, {**tree, "layers": _np(ja)})
    for a, b in zip(port_again["layers"], params["layers"]):
        assert torch.equal(a["self_attn"]["q_proj"]["qweight"],
                           b["self_attn"]["q_proj"]["qweight"])


def test_pipe_meshes_axes_coordinates_and_neighbours(run):
    """``build_mesh(pipe=2)`` over four ranks is (data, pipe, expert,
    tensor) in JAX's row-major order: rank r sits at data r // 2, stage
    r % 2, its neighbour one rank away; with tensor 2 the stages are two
    ranks apart; pipe 4 chains the four ranks; each pipe group sums over
    its own ranks."""
    _, res = run
    for rank, r in enumerate(res):
        m = r["meshes"][(("pipe", 2),)]
        assert m["axes"] == ("data", "pipe", "expert", "tensor")
        assert m["shape"] == {"data": 2, "pipe": 2, "expert": 1,
                              "tensor": 1}
        assert m["coords"] == {"data": rank // 2, "pipe": rank % 2,
                               "expert": 0, "tensor": 0}
        assert m["pipe"] == ((None, rank + 1) if rank % 2 == 0
                             else (rank - 1, None))
        assert m["sum"] == 2
        m = r["meshes"][(("pipe", 2), ("tensor", 2))]
        assert m["coords"] == {"data": 0, "pipe": rank // 2, "expert": 0,
                               "tensor": rank % 2}
        assert m["pipe"] == ((None, rank + 2) if rank < 2
                             else (rank - 2, None))
        m = r["meshes"][(("pipe", 4),)]
        assert m["pipe"] == (rank - 1 if rank else None,
                             rank + 1 if rank < 3 else None)
        assert m["sum"] == 4
