"""Tensor parallelism of the port on the CPU, in one gloo world of four
ranks (``tests/torch_parallel_ranks.py``), against the JAX package on its
8 virtual CPU devices: the sharding of the tree, the forward at tensor 2
and 4 (JAX's sharded and unsharded forward), the TP decode step through
K5's twin on each rank's heads (JAX's ``fused_attention_step_tp`` under
``AWQ_TPU_FUSED_ATTN=force``), the decode MLP through K8's twin on each
rank's slice (JAX's ``fused_mlp_sharded``), the slot engine over TP
parameters, and the refusals.

Inputs are seeded JAX trees carried into the port by
``convert.from_jax_params``. Tolerances: f32 logits and MLP outputs
rtol = atol = 2e-4 (JAX's own, ``tests/test_parallel.py``: the sharded
runs differ from one process only in the order of the sums); decode
logits 2e-3 (JAX's, ``tests/test_tp_attn.py``); greedy streams and the
tree's shards exactly."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import sharded_mlp as jsm
from autoawq_tpu.parallel.mesh import build_mesh as jax_mesh
from autoawq_tpu.parallel.specs import param_specs, shard_params as jshard
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.serve.batching import BatchingEngine as JaxEngine
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.api import AwqCausalLM
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.core.packing import unpack_port
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn.fuse import tp_stack_qkv
from autoawq_tpu_torch.ops.gemm import dequantize
from autoawq_tpu_torch.parallel.mesh import build_mesh
from autoawq_tpu_torch.serve.batching import BatchingEngine

# tests/test_parallel.py:42-64's model, with room for a 128-token prompt
TP = dict(model_type="llama", vocab_size=128, hidden_size=256,
          intermediate_size=4096, num_hidden_layers=1, num_attention_heads=8,
          num_key_value_heads=4, head_dim=32, max_position_embeddings=128)
# ragged per-rank widths (k / v 10 columns a rank at tensor 2, padded to
# 12), o's 5 groups (replicated), down's 44 groups (22 a rank: zeros
# repacked), KV heads that do not divide tensor 4
TREE = dict(model_type="llama", vocab_size=64, hidden_size=64,
            intermediate_size=1408, num_hidden_layers=1,
            num_attention_heads=16, num_key_value_heads=2, head_dim=10,
            max_position_embeddings=64)
# tests/test_tp_attn.py's model at one layer; its own vocab, because JAX
# reads AWQ_TPU_FUSED_ATTN when it traces the decode step
K5 = dict(model_type="llama", vocab_size=384, hidden_size=256,
          intermediate_size=512, num_hidden_layers=1, num_attention_heads=8,
          num_key_value_heads=4, head_dim=32, max_position_embeddings=128)
# tests/test_parallel.py:314-346's engine model
ENG = dict(model_type="llama", vocab_size=512, hidden_size=256,
           intermediate_size=4096, num_hidden_layers=2,
           num_attention_heads=8, num_key_value_heads=4, head_dim=32,
           max_position_embeddings=64)
TOL = 2e-4
CASES = ["tp_forward", "tree_shards", "tp_decode", "tp_mlp", "tp_engine",
         "meshes"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _synth(d, seed=0, group_size=128):
    return _np(jax_synth(JaxConfig(**d), seed=seed, group_size=group_size,
                         fp_dtype=jnp.float32))


def _mesh(t):
    return jax_mesh(tensor=t, data=jax.device_count() // t)


def _sharded_forward(cfg, params, tokens, t):
    mesh = _mesh(t)
    with mesh:
        sharded = jshard(params, mesh)
        return np.asarray(jax.jit(lambda p, x: jm.forward(
            cfg, p, x, method="jnp"))(sharded, jnp.asarray(tokens)))


def _decode_logits(cfg, params, prompt, mesh=None):
    """JAX's prefill, then one decode step (jitted on the mesh when one is
    given), f32; as tests/test_tp_attn.py."""
    caches = jgen.init_kv_cache(cfg, prompt.shape[0], 64, jnp.float32)
    logits, caches = jgen.prefill(cfg, params, jnp.asarray(prompt), caches,
                                  "jnp", jnp.float32)
    tok = jnp.argmax(logits, -1)[:, None]
    step = prompt.shape[1]
    if mesh is None:
        out, _ = jgen.decode_step(cfg, params, tok, caches,
                                  jnp.int32(step), "jnp", jnp.float32)
        return np.asarray(out)
    with mesh:
        sharded = jshard(params, mesh, dtype=jnp.float32)
        out, _ = jax.jit(lambda p, t, c: jgen.decode_step(
            cfg, p, t, c, jnp.int32(step), "auto", jnp.float32))(
            sharded, tok, caches)
    return np.asarray(out)


@pytest.fixture(scope="module")
def run():
    """Spawn the world, compute the JAX side while it runs, then join."""
    rng = np.random.default_rng(0)
    jtp, jtree, jk5, jeng = (JaxConfig(**d) for d in (TP, TREE, K5, ENG))
    tp, tree = _synth(TP), _synth(TREE, group_size=32)
    k5, eng = _synth(K5, group_size=64), _synth(ENG, seed=1)
    tokens = {"decode": rng.integers(0, 128, (2, 8)),
              "prefill": rng.integers(0, 128, (2, 128))}
    k5_prompt = rng.integers(0, K5["vocab_size"], (8, 16))
    mlp_x = rng.standard_normal((1, 1, 256)).astype(np.float32)
    prompts = [np.random.default_rng(42).integers(0, 512, (n,))
               for n in (5, 9)]
    tree_tokens = rng.integers(0, 64, (2, 8))
    port = {name: (ModelConfig(**d), from_jax_params(ModelConfig(**d), p))
            for name, d, p in (("tp", TP, tp), ("tree", TREE, tree),
                               ("k5", K5, k5), ("eng", ENG, eng))}
    t = torch.from_numpy
    inputs = {
        "tp_cfg": port["tp"][0], "tp_params": port["tp"][1],
        "tp_tokens": {k: t(v) for k, v in tokens.items()},
        "tree_cfg": port["tree"][0], "tree_params": port["tree"][1],
        "tree_tokens": t(tree_tokens),
        "k5_cfg": port["k5"][0], "k5_params": port["k5"][1],
        "k5_prompt": t(k5_prompt), "mlp_x": t(mlp_x),
        "eng_cfg": port["eng"][0], "eng_params": port["eng"][1],
        "eng_prompts": prompts}
    world = ranks.start_world(4, CASES, inputs)

    fwd = jax.jit(jm.forward, static_argnums=0,
                  static_argnames=("method",))
    ref = {"tp": {k: np.asarray(fwd(jtp, tp, jnp.asarray(v), method="jnp"))
                  for k, v in tokens.items()},
           "tree": np.asarray(fwd(jtree, tree, jnp.asarray(tree_tokens),
                                  method="jnp"))}
    for tt in (2, 4):
        for k, v in tokens.items():
            ref[("tp", tt, k)] = _sharded_forward(jtp, tp, v, tt)
        ref[("specs", tt)] = {
            path: spec for path, spec in _jax_decisions(tree, tt).items()}
    old = os.environ.get("AWQ_TPU_FUSED_ATTN")
    os.environ["AWQ_TPU_FUSED_ATTN"] = "force"
    try:
        for tt in (2, 4):
            stacked = jfuse.tp_stack_qkv(jk5, copy.deepcopy(k5), tt)
            ref[("k5", tt)] = _decode_logits(jk5, stacked, k5_prompt,
                                             _mesh(tt))
    finally:
        if old is None:
            del os.environ["AWQ_TPU_FUSED_ATTN"]
        else:
            os.environ["AWQ_TPU_FUSED_ATTN"] = old
    m = tp["layers"][0]["mlp"]
    for tt in (2, 4):
        mesh = _mesh(tt)
        with mesh:
            sh = jshard(m, mesh)
            ref[("k8", tt)] = np.asarray(jax.jit(lambda g, u, d, x: (
                jsm.fused_mlp_sharded(x, g, u, d, inter=4096,
                                      out_features=256, act="silu",
                                      interpret=True)))(
                sh["gate_proj"], sh["up_proj"], sh["down_proj"],
                jnp.asarray(mlp_x[0])))
    ref["k8"] = np.asarray(jm.mlp(jtp, m, jnp.asarray(mlp_x), method="jnp"))
    je = JaxEngine(jeng, eng, max_batch=2, max_seq_len=48, method="jnp",
                   dtype=jnp.float32)
    for i, pr in enumerate(prompts):
        je.add_request(i, pr, 8)
    ref["engine"] = je.run()
    return inputs, ref, world.results()


def _jax_decisions(tree, t):
    """JAX's param_specs decision of each linear: col, row or rep."""
    specs = param_specs(tree, _mesh(t))
    out = {}
    for name, sub in specs["layers"][0].items():
        if not isinstance(sub, dict):
            continue
        for lin, s in sub.items():
            if isinstance(s, dict) and "qweight" in s:
                spec = tuple(s["qweight"].spec)
                kind = ("col" if spec[1:2] == ("tensor",) else
                        "row" if spec[:1] == ("tensor",) else "rep")
                out[f"layers.0.{name}.{lin}"] = kind
    return out


def _same_on_every_rank(res, case, key):
    first = res[0][case][key]
    for r in res[1:]:
        assert torch.equal(r[case][key], first), (case, key)
    return first.numpy()


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("prompt", ["decode", "prefill"])
def test_tp_forward_equals_jax_sharded_and_unsharded(run, t, prompt):
    """Logits at tensor t through the K1-size (M = 16) and K2-size
    (M = 256) routes' twins, equal on every rank, against JAX's forward on
    its shard_params tree and on the whole tree."""
    _, ref, res = run
    got = _same_on_every_rank(res, "tp_forward", (t, prompt))
    np.testing.assert_allclose(got, ref[("tp", t, prompt)], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, ref["tp"][prompt], rtol=TOL, atol=TOL)


def _full_tree(inputs):
    cfg, params = inputs["tree_cfg"], inputs["tree_params"]
    full = ranks._copy(params)
    tp_stack_qkv(cfg, full, 2)
    return cfg, full["layers"][0]


def test_tree_shards_concatenate_to_the_unsharded_tree(run):
    """At tensor 2 the ranks' column shards (q, k, v, gate, up; k and v
    ragged: 10 columns a rank, padded to 12) concatenate to the unsharded
    leaves bit for bit, down's row shards (22 of 44 groups a rank, zero
    points repacked) stack to them, o (whose K the JAX loader padded)
    replicates, and the qkv stack's entries are the unsharded stack's."""
    inputs, _, res = run
    cfg, full = _full_tree(inputs)
    locals_ = [r["tree_shards"]["local"]["layers"][0] for r in res[:2]]
    for sub, name, n in (("self_attn", "q_proj", 80),
                         ("self_attn", "k_proj", 10),
                         ("self_attn", "v_proj", 10),
                         ("mlp", "gate_proj", 704), ("mlp", "up_proj", 704)):
        for leaf in ("qweight", "scales", "qzeros"):
            parts = [loc[sub][name][leaf] for loc in locals_]
            assert all(p.shape[1] == -(-n // 4) * 4 for p in parts)
            cat = torch.cat([p[:, :n] for p in parts], dim=1)
            assert torch.equal(cat, full[sub][name][leaf][:, :2 * n])
    down = [loc["mlp"]["down_proj"] for loc in locals_]
    for leaf in ("qweight", "scales"):
        assert torch.equal(torch.cat([d[leaf] for d in down]),
                           full["mlp"]["down_proj"][leaf])
    assert all(d["qzeros"].shape[0] == 3 for d in down)  # ceil(22 / 8)
    z = torch.cat([unpack_port(d["qzeros"], rows=22) for d in down])
    assert torch.equal(z, unpack_port(full["mlp"]["down_proj"]["qzeros"],
                                      rows=44))
    for leaf, v in full["self_attn"]["o_proj"].items():
        assert all(torch.equal(loc["self_attn"]["o_proj"][leaf], v)
                   for loc in locals_)
    assert res[0]["tree_shards"]["o_marker"] == ["tp_gather"]
    for leaf, v in full["self_attn"]["qkv_proj_tp"].items():
        assert torch.equal(torch.stack(
            [loc["self_attn"]["qkv_proj_tp"][leaf] for loc in locals_]), v)


def test_qkv_stack_entries_dequantize_to_the_heads_slices(run):
    """Entry i of the port's qkv stack dequantizes to [q_i | k_i | v_i],
    as JAX's ``tp_stack_qkv`` entry i does (tests/test_tp_attn.py)."""
    inputs, _, _ = run
    cfg, full = _full_tree(inputs)
    attn = full["self_attn"]
    deq = {n: dequantize(attn[n]["qweight"], attn[n]["scales"],
                         attn[n]["qzeros"])
           for n in ("q_proj", "k_proj", "v_proj")}
    st = attn["qkv_proj_tp"]
    for i in range(2):
        got = dequantize(st["qweight"][i], st["scales"][i],
                         st["qzeros"][i])[:, :100]
        want = torch.cat([deq["q_proj"][:, 80 * i:80 * (i + 1)],
                          deq["k_proj"][:, 10 * i:10 * (i + 1)],
                          deq["v_proj"][:, 10 * i:10 * (i + 1)]], dim=1)
        assert torch.equal(got, want)


# the port shards what JAX's planar layout replicates (ROADMAP §3): its
# columns need no 256-lane superblocks, its rows no even group counts
DELIBERATE = {("rep", "col"), ("rep", "row")}


@pytest.mark.parametrize("t", [2, 4])
def test_decisions_are_jax_s_or_listed_differences(run, t):
    """Each linear's decision (column, row or replicate) is JAX's
    ``param_specs`` decision, or the port shards what JAX replicates."""
    _, ref, res = run
    got = res[0]["tree_shards"]["decisions"][t]
    want = ref[("specs", t)]
    assert set(got) == set(want)
    diffs = {(want[p], got[p]) for p in got if got[p] != want[p]}
    assert diffs <= DELIBERATE, diffs
    if t == 2:  # 22 groups a rank: both split down's rows
        assert want["layers.0.mlp.down_proj"] == "row" \
            == got["layers.0.mlp.down_proj"]


def test_tree_with_ragged_shards_forward_equals_jax(run):
    """The ragged tree's tensor-2 forward (o through its all-gathered
    input) against JAX's unsharded forward."""
    _, ref, res = run
    got = _same_on_every_rank(res, "tree_shards", "logits")
    np.testing.assert_allclose(got, ref["tree"], rtol=TOL, atol=TOL)


def test_refused_shard_leaves_the_tree_untouched(run):
    """Tensor 4 does not divide 2 KV heads: ``shard`` raises JAX's message
    and the caller's tree gains nothing (no qkv stack)."""
    _, _, res = run
    out = res[0]["tree_shards"]
    assert out["refusal"] == "heads (16/2) not divisible by tp=4"
    assert out["untouched"]


def test_tp_stack_refuses_heads_that_do_not_divide():
    """``nn/fuse.tp_stack_qkv`` raises JAX's message (tests/test_tp_attn.py's
    ``test_tp_stack_rejects_indivisible_heads``) and adds nothing."""
    cfg = ModelConfig(**K5)
    params = from_jax_params(cfg, _synth(K5, group_size=64))
    with pytest.raises(ValueError, match="divisible"):
        tp_stack_qkv(cfg, params, 3)
    assert "qkv_proj_tp" not in params["layers"][0]["self_attn"]


def test_pipe_and_hybrid_meshes_name_the_item_that_carries_them(run):
    """The meshes the port once refused: ``build_mesh(pipe=2)`` over four
    ranks is (data, pipe, expert, tensor), each rank at JAX's row-major
    coordinates with its pipe group of two; ``hybrid_mesh(tensor=2)`` over
    two nodes of two ranks (``LOCAL_WORLD_SIZE`` = 2) is (data, expert,
    tensor) with data across the nodes. Without a world, a mesh of two
    ranks is still refused."""
    _, _, res = run
    for rank, r in enumerate(res):
        m = r["meshes"][(("pipe", 2),)]
        assert m["axes"] == ("data", "pipe", "expert", "tensor")
        assert m["coords"] == {"data": rank // 2, "pipe": rank % 2,
                               "expert": 0, "tensor": 0}
        assert m["sum"] == 2
        h = r["meshes"]["hybrid"][(("tensor", 2),)]
        assert h["axes"] == ("data", "expert", "tensor")
        assert h["coords"] == {"data": rank // 2, "expert": 0,
                               "tensor": rank % 2}
    with pytest.raises(ValueError, match="not divisible"):
        build_mesh(tensor=2)  # one process, no world: 1 device


def test_hybrid_mesh_shapes(run):
    """JAX's ``test_hybrid_mesh_shapes`` on the port's world of four ranks
    as two nodes: the (data, expert, tensor) axes, data = devices //
    (tensor x expert) with the node count as its DCN factor, an explicit
    ``dcn_data`` that leaves data's size as it is, node k's ranks at data
    indices of node k, and JAX's errors."""
    _, _, res = run
    for rank, r in enumerate(res):
        hy = r["meshes"]["hybrid"]
        assert hy[(("tensor", 2),)]["shape"] == {"data": 2, "expert": 1,
                                                 "tensor": 2}
        assert hy[(("tensor", 2),)]["data_sum"] == 2
        assert hy[(("expert", 2),)]["shape"] == {"data": 2, "expert": 2,
                                                 "tensor": 1}
        assert hy[(("expert", 2),)]["coords"]["data"] == rank // 2
        assert hy[(("dcn_data", 1), ("tensor", 2))]["shape"]["data"] == 2
        assert hy[(("tensor", 1),)]["shape"]["data"] == 4
        assert hy[(("tensor", 1),)]["coords"]["data"] == rank
        assert r["meshes"]["hybrid_errors"] == [
            "2 per-slice devices not divisible by tensor=2 x expert=2",
            "2 per-slice devices not divisible by tensor=3 x expert=1",
            "mesh dcn2 x ici2 x expert1 x tensor2 != 4 devices"]


@pytest.mark.parametrize("t", [2, 4])
def test_tp_decode_step_through_k5_per_rank(run, t):
    """B = 8 decode logits through K5's twin on each rank's heads (every
    layer, every rank, every step: the calls counted) against JAX's
    ``fused_attention_step_tp`` forced on its mesh, and against the
    unsharded port's plain step."""
    _, ref, res = run
    got = _same_on_every_rank(res, "tp_decode", t)
    assert res[0]["tp_decode"]["k5_calls"] == 2  # a layer, t = 2 and 4
    np.testing.assert_allclose(got, ref[("k5", t)], rtol=2e-3, atol=2e-3)
    plain = res[0]["tp_decode"]["plain"].numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("t", [2, 4])
def test_tp_decode_mlp_through_k8_per_rank(run, t):
    """The decode MLP through K8's twin on each rank's I/t slice plus the
    all-reduce, against JAX's ``fused_mlp_sharded`` on its mesh and its
    jnp MLP."""
    _, ref, res = run
    got = _same_on_every_rank(res, "tp_mlp", t)
    np.testing.assert_allclose(got[0], ref[("k8", t)], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref["k8"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("burst", [1, 4])
@pytest.mark.parametrize("t", [2, 4])
def test_slot_engine_over_tp_streams(run, t, burst):
    """The slot engine over each rank's tree gives the unsharded port's
    greedy streams and JAX's, at burst 1 and 4."""
    inputs, ref, res = run
    eng = BatchingEngine(inputs["eng_cfg"], inputs["eng_params"],
                         max_batch=2, max_seq_len=48, dtype=torch.float32,
                         device="cpu")
    for i, pr in enumerate(inputs["eng_prompts"]):
        eng.add_request(i, pr, 8)
    plain = eng.run()
    for r in res:
        assert r["tp_engine"][(t, burst)] == plain
    assert {k: list(map(int, v)) for k, v in plain.items()} == \
        {k: list(map(int, v)) for k, v in ref["engine"].items()}


def test_tensor_one_leaves_the_model_as_it_is():
    """A mesh of one rank (no world) shards nothing: the same tree, the
    same config, no marker."""
    cfg = ModelConfig(**TP)
    params = from_jax_params(cfg, _synth(TP))
    m = AwqCausalLM(cfg, params, device="cpu").shard(build_mesh(),
                                                      dtype=None)
    assert m.cfg is cfg and m.params is params
