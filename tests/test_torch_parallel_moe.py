"""Expert parallelism of the port on the CPU, in one gloo world of two ranks
(``tests/torch_parallel_ranks.py``), against the JAX package on an
``expert`` mesh of 2 of its virtual CPU devices: replicate-and-sum
(``ops/sharded_moe.py`` against JAX's ``moe_mlp_sharded``) and the
all-to-all dispatch (``ops/moe_a2a.py`` against JAX's ``moe_mlp_a2a``) at
a capacity factor that drops nothing and at one that drops entries, and a
Mixtral forward through ``shard`` under both schemes and under tensor 2.

Inputs are JAX's seeded stacked experts (``tests/test_moe_a2a.py:28-70``)
carried into the port by ``convert``. Tolerances: rtol = atol = 2e-4 (f32;
only the order of the sums differs); the dropped entries are JAX's
exactly (the same rows zero, the same rows kept)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.nn.fuse import fuse_model as jax_fuse
from autoawq_tpu.ops import moe_a2a as ja2a
from autoawq_tpu.ops import sharded_moe as jsm
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params, stacked_from_planar
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn.fuse import fuse_model

# tests/test_moe_a2a.py's experts: 8 of 256 -> 256 -> 256, top-2, g64
EXPERTS = dict(model_type="mixtral", vocab_size=64, hidden_size=256,
               intermediate_size=256, num_hidden_layers=1,
               num_attention_heads=4, num_key_value_heads=2, head_dim=64,
               num_experts=8, num_experts_per_tok=2,
               max_position_embeddings=32)
# tests/test_parallel.py's expert-parallel Mixtral (4 experts, g64)
MOE = dict(EXPERTS, num_experts=4)
TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _expert_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:2]), ("expert",))


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(42)
    jcfg = JaxConfig(**EXPERTS)
    stacked = _np(jax_fuse(jcfg, jax_synth(jcfg, seed=9, group_size=64))[
        "layers"][0]["mlp"]["experts_stacked"])
    t, h, k = 32, 256, 2
    x = rng.standard_normal((t, h)).astype(np.float32)
    topi = rng.integers(0, 8, (t, k))
    topw = np.array(jax.nn.softmax(
        rng.standard_normal((t, k)).astype(np.float32), -1))
    # every token to expert 0 overflows a capacity of 1.0 (JAX's case)
    t2 = 32
    x2 = rng.standard_normal((t2, h)).astype(np.float32)
    topi2 = np.zeros((t2, k), np.int64)
    topw2 = np.full((t2, k), 1.0 / k, np.float32)
    a2a = {"fits": (x, topw, topi, 8.0), "drops": (x2, topw2, topi2, 1.0)}

    mcfg = JaxConfig(**MOE)
    moe = _np(jax_synth(mcfg, seed=7, group_size=64))
    moe_tokens = rng.integers(0, 64, (2, 8))
    pcfg = ModelConfig(**MOE)
    tt = torch.from_numpy
    inputs = {
        "ep_stacked": {name: stacked_from_planar(lin, 256 * (
            2 if name == "gate_up_proj" else 1))
            for name, lin in stacked.items()},
        "ep_x": tt(x), "ep_topw": tt(topw), "ep_topi": tt(topi),
        "ep_inter": 256,
        "ep_a2a": {n: (tt(a), tt(b), tt(c), cf)
                   for n, (a, b, c, cf) in a2a.items()},
        "moe_cfg": pcfg,
        "moe_params": fuse_model(pcfg, from_jax_params(pcfg, moe)),
        "moe_tokens": tt(moe_tokens)}
    world = ranks.start_world(2, ["ep_ops", "ep_model"], inputs)

    mesh = _expert_mesh()
    ref = {}
    with mesh:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = jax.tree_util.tree_map(
            lambda a: jax.device_put(jnp.asarray(a),
                                     NamedSharding(mesh, P("expert"))),
            stacked)
        ref["replicate"] = np.asarray(jax.jit(lambda s, a, w, i: (
            jsm.moe_mlp_sharded(s, a, w, i, "silu", 256, interpret=True)))(
            sh, jnp.asarray(x), jnp.asarray(topw), jnp.asarray(topi)))
        for name, (a, w, i, cf) in a2a.items():
            ref[name] = np.asarray(jax.jit(lambda s, a, w, i, cf=cf: (
                ja2a.moe_mlp_a2a(s, a, w, i, "silu", 256, mesh=mesh,
                                 capacity_factor=cf, interpret=True)))(
                sh, jnp.asarray(a), jnp.asarray(w), jnp.asarray(i)))
    fused = jax_fuse(mcfg, copy.deepcopy(moe))
    ref["model"] = np.asarray(jax.jit(lambda p, s: jm.forward(
        mcfg, p, s, method="jnp", dtype=np.float32))(
        fused, jnp.asarray(moe_tokens)))
    return inputs, ref, world.results()


def _same(res, case, key):
    first = res[0][case][key]
    assert torch.equal(res[1][case][key], first)
    return first.numpy()


def test_replicate_and_sum_equals_jax_sharded_moe(run):
    """Each rank's 4 experts on every token, routing masked to its ids,
    summed over the expert group: JAX's ``moe_mlp_sharded`` on its expert
    mesh."""
    _, ref, res = run
    np.testing.assert_allclose(_same(res, "ep_ops", "replicate"),
                               ref["replicate"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["fits", "drops"])
def test_all_to_all_equals_jax_and_drops_what_jax_drops(run, case):
    """The all-to-all dispatch over each rank's 16 tokens at
    capacity factor 8 (nothing dropped) and 1 with every entry routed to
    expert 0 (entries past the capacity dropped): JAX's
    ``moe_mlp_a2a``, with the same rows zero."""
    _, ref, res = run
    got = _same(res, "ep_ops", case)
    np.testing.assert_allclose(got, ref[case], rtol=TOL, atol=TOL)
    dropped = np.abs(got).sum(1) == 0
    assert np.array_equal(dropped, np.abs(ref[case]).sum(1) == 0)
    assert dropped.any() == (case == "drops")


@pytest.mark.parametrize("key", [("expert", "replicate"),
                                 ("expert", "a2a"), "tensor"])
def test_mixtral_forward_through_shard(run, key):
    """A Mixtral forward through ``AwqCausalLM.shard``: experts over an
    expert axis of 2 under each dispatch scheme, or attention over a
    tensor axis of 2 with the experts replicated, against JAX's forward
    (tests/test_parallel.py holds JAX's (tensor 2, expert 2) sharded
    forward to it)."""
    _, ref, res = run
    got = _same(res, "ep_model", key)
    np.testing.assert_allclose(got, ref["model"], rtol=TOL, atol=TOL)
