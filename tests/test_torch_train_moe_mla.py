"""Training through MoE and MLA in the port, held against the JAX package
on the CPU (f32, JAX with ``method="jnp"``, the port on its plain path).
Inputs are seeded numpy arrays: JAX's quantized ``utils/synth`` trees (or
its float ``init_random_params``) carried over by
``convert.from_jax_params``, at the tiny widths of
``tests/test_torch_mla.py`` (hidden 64, 4 heads, 4-8 experts).

(a) The absorbed MLA decode folds a kv_b adapter into kv_b's dense
weight, as JAX's ``_dense_weight`` does: with a nonzero seeded ``lora_b``
(``add_lora`` leaves B at zero, which hides a dropped adapter), the
latent cache's prefill and 4 teacher-forced decode steps give JAX's
logits within 1e-4 of their scale, and the port's materialized per-head
decode's within 1e-4 (the absorbed einsums sum in another order), float
and quantized (kv_b's ``dense`` leaf).
(b) ``jax.vjp`` of ``moe_block`` against ``torch.autograd``: the output,
dx and the router kernel's gradient (the path through ``topw``) within
1e-5 of each JAX tensor's largest magnitude, for every router kind; the
port takes its routed-rows route (each expert on the rows routed to it).
A stacked block's output and gradients equal the list form's within
1e-5 (one fused gate_up product against two).
(c) ``jax.vjp`` of ``mla_attention`` (the materialized prefill) for lite
q and q_lora, float and quantized, with yarn: the output, dx and the kv_b
adapter's gradients within 1e-5 of their scale.
(d) ``add_lora`` on MoE and MLA roles draws JAX's leaves (equal), and three
AdamW steps on tiny Mixtral and DeepSeek-V2 trees give JAX's
``lora_train_step_optax`` losses within 1e-5 relative and adapters within
3e-3 of three learning rates (``tests/test_torch_train.py``'s rule).
(f) An expert-parallel stack under grad raises NotImplementedError in the
port, as jax.grad through JAX's grouped kernel raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.io import hf as jhf
from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import fuse as jfuse
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.serve import generate as jgen
from autoawq_tpu.train import lora as jlora
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import fuse, modules
from autoawq_tpu_torch.parallel.mesh import Axis
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.train import lora
from autoawq_tpu_torch.utils.tree import tensor_leaves
from test_torch_mla import FAMILIES, _YARN

V = 128


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


def close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _configs(d):
    return JaxConfig.from_hf_dict(d), ModelConfig.from_hf_dict(d)


def _quant_tree(jcfg, seed=0, gs=32):
    """JAX's quantized synth (every layer MoE for an MoE config), the
    router's correction bias drawn for ``noaux_tc``."""
    tree = _np(jax_synth(jcfg, seed=seed, group_size=gs,
                         fp_dtype="float32"))
    if jcfg.topk_method == "noaux_tc":
        rng = np.random.default_rng(seed + 1)
        for lp in tree["layers"]:
            if "gate" in lp["mlp"]:
                lp["mlp"]["gate"]["e_score_correction_bias"] = (
                    rng.standard_normal(jcfg.num_experts) * 0.05).astype(
                        np.float32)
    return tree


# --------------------------------------------------------------------------
# (a) the absorbed decode's kv_b adapter
# --------------------------------------------------------------------------

def _v2_lite_with_kv_b_adapter(quantized):
    jcfg, cfg = _configs(FAMILIES["deepseek_v2_lite"])
    if quantized:
        tree = _quant_tree(jcfg)
    else:
        tree = _np(jhf.init_random_params(jcfg, seed=0))
    jlora.add_lora(jcfg, tree, rank=4, targets=("kv_b_proj",))
    tree = _np(tree)
    rng = np.random.default_rng(1)
    for lp in tree["layers"]:
        b = lp["self_attn"]["kv_b_proj"]["lora_b"]
        lp["self_attn"]["kv_b_proj"]["lora_b"] = (
            0.5 * rng.standard_normal(b.shape)).astype(np.float32)
    params = from_jax_params(cfg, tree)
    if quantized:
        fuse.attach_kv_b_dense(cfg, params)
        assert all("dense" in lp["self_attn"]["kv_b_proj"]
                   for lp in params["layers"])
    return jcfg, cfg, _jnp(tree), params


def _port_decode(cfg, params, prompt, steps, mla_latent):
    b, s = prompt.shape
    caches = gen.init_kv_cache(cfg, b, s + len(steps), torch.float32, "cpu",
                               mla_latent=mla_latent)
    logits, caches = gen.prefill(cfg, params, torch.from_numpy(prompt),
                                 caches, dtype=torch.float32)
    out = [logits]
    for i, tok in enumerate(steps):
        logits, caches = gen.decode_step(cfg, params, torch.from_numpy(tok),
                                         caches, s + i, dtype=torch.float32)
        out.append(logits)
    return torch.stack(out).numpy()


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "dense_leaf"])
def test_latent_decode_folds_the_kv_b_adapter(quantized):
    jcfg, cfg, jp, pp = _v2_lite_with_kv_b_adapter(quantized)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, V, (2, 8))
    steps = [rng.integers(0, V, (2, 1)) for _ in range(4)]
    caches = jgen.init_kv_cache(jcfg, 2, 12, dtype=jnp.float32)
    logits, caches = jgen.prefill(jcfg, jp, jnp.asarray(prompt), caches,
                                  method="jnp", dtype=jnp.float32)
    ref = [np.asarray(logits)]
    for i, tok in enumerate(steps):
        logits, caches = jgen.decode_step(jcfg, jp, jnp.asarray(tok), caches,
                                          jnp.int32(8 + i), method="jnp",
                                          dtype=jnp.float32)
        ref.append(np.asarray(logits))
    ref = np.stack(ref)
    latent = _port_decode(cfg, pp, prompt, steps, mla_latent=True)
    materialized = _port_decode(cfg, pp, prompt, steps, mla_latent=False)
    close(latent, ref, 1e-4)
    close(latent, materialized, 1e-4)


# --------------------------------------------------------------------------
# (b) moe_block under grad
# --------------------------------------------------------------------------

_MOE = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=4,
            max_position_embeddings=64, num_hidden_layers=1)
MOE_CASES = {
    "mixtral_softmax_renorm": dict(
        _MOE, model_type="mixtral", num_local_experts=4,
        num_experts_per_tok=2),
    "qwen3_moe_norm_topk_prob": dict(FAMILIES["qwen3_moe"],
                                     num_hidden_layers=1),
    "qwen2_moe_gated_shared_expert": dict(
        FAMILIES["qwen3_moe"], num_hidden_layers=1, norm_topk_prob=False,
        shared_expert_intermediate_size=96),
    "deepseek_v2_group_limited_greedy": dict(
        FAMILIES["deepseek_v2_q_lora"], num_hidden_layers=1,
        first_k_dense_replace=0),
    "deepseek_v3_noaux_tc": dict(FAMILIES["deepseek_v3"],
                                 num_hidden_layers=1,
                                 first_k_dense_replace=0),
}


def _moe_layer(name):
    jcfg, cfg = _configs(MOE_CASES[name])
    tree = _quant_tree(jcfg)
    return jcfg, cfg, tree["layers"][0]["mlp"], \
        from_jax_params(cfg, tree)["layers"][0]["mlp"]


def _moe_inputs(h, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 12, h)).astype(np.float32),
            rng.standard_normal((2, 12, h)).astype(np.float32))


def _port_moe_vjp(cfg, pm, x, g):
    xt = torch.from_numpy(x).requires_grad_()
    gk = pm["gate"]["kernel"].clone().requires_grad_()
    y = modules.moe_block(cfg, {**pm, "gate": {**pm["gate"], "kernel": gk}},
                          xt)
    dx, dg = torch.autograd.grad(y, [xt, gk], torch.from_numpy(g))
    return y.detach(), dx, dg


@pytest.fixture
def routed_calls(monkeypatch):
    calls = []
    real = modules._routed_rows

    def spy(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)

    monkeypatch.setattr(modules, "_routed_rows", spy)
    return calls


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_block_vjp_equals_jax(name, routed_calls):
    jcfg, cfg, jmlp, pm = _moe_layer(name)
    x, g = _moe_inputs(jcfg.hidden_size)
    jmlp = _jnp(jmlp)

    def f(x, gk):
        return jm.moe_block(jcfg, {**jmlp, "gate": {**jmlp["gate"],
                                                     "kernel": gk}}, x,
                            method="jnp")

    y, vjp = jax.vjp(f, jnp.asarray(x), jmlp["gate"]["kernel"])
    jdx, jdg = vjp(jnp.asarray(g))
    py, pdx, pdg = _port_moe_vjp(cfg, pm, x, g)
    assert routed_calls == [len(pm["experts"])]
    close(py, y, 1e-5)
    close(pdx, jdx, 1e-5)
    close(pdg, jdg, 1e-5)
    assert float(np.abs(np.asarray(jdg)).max()) > 0  # the router path


def test_moe_cases_cover_every_router_and_shared_expert():
    kinds = set()
    for name in MOE_CASES:
        jcfg, cfg, jmlp, pm = _moe_layer(name)
        kinds.add((cfg.model_type, cfg.topk_method, cfg.scoring_func,
                   bool(cfg.norm_topk_prob)))
        kinds.update(k for k in ("shared_expert", "shared_expert_gate",
                                 "shared_experts") if k in pm)
        if "e_score_correction_bias" in pm["gate"]:
            kinds.add("bias")
    assert {"shared_expert", "shared_expert_gate", "shared_experts",
            "bias"} <= kinds
    assert ("deepseek_v3", "noaux_tc", "sigmoid", True) in kinds
    assert ("deepseek_v2", "group_limited_greedy", "softmax", False) in kinds
    assert any(k[0] == "mixtral" for k in kinds if isinstance(k, tuple))


@pytest.mark.parametrize("name", ["mixtral_softmax_renorm",
                                  "deepseek_v3_noaux_tc"])
def test_stacked_experts_grads_equal_the_list_form(name, routed_calls):
    jcfg, cfg, _, pm = _moe_layer(name)
    st = fuse.stack_experts(cfg, pm)
    assert "experts_stacked" in st and "experts" not in st
    x, g = _moe_inputs(jcfg.hidden_size, seed=4)
    want = _port_moe_vjp(cfg, pm, x, g)
    got = _port_moe_vjp(cfg, st, x, g)
    assert len(routed_calls) == 2
    for a, b in zip(got, want):
        close(a, b, 1e-5)


# --------------------------------------------------------------------------
# (c) mla_attention under grad
# --------------------------------------------------------------------------

MLA_CASES = {"lite": dict(FAMILIES["deepseek_v2_lite"]),
             "q_lora": dict(FAMILIES["deepseek_v2_q_lora"],
                            rope_scaling=_YARN)}


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int4"])
@pytest.mark.parametrize("name", sorted(MLA_CASES))
def test_mla_attention_vjp_equals_jax(name, quantized):
    jcfg, cfg = _configs(MLA_CASES[name])
    assert jcfg.rope_type == "yarn"
    tree = (_quant_tree(jcfg) if quantized
            else _np(jhf.init_random_params(jcfg, seed=0)))
    jlora.add_lora(jcfg, tree, rank=4, targets=("kv_b_proj",), seed=5)
    tree = _np(tree)
    rng = np.random.default_rng(6)
    kv_b = tree["layers"][0]["self_attn"]["kv_b_proj"]
    kv_b["lora_b"] = (0.1 * rng.standard_normal(
        kv_b["lora_b"].shape)).astype(np.float32)
    pa = from_jax_params(cfg, tree)["layers"][0]["self_attn"]
    assert ("qweight" in pa["kv_b_proj"]) == quantized
    ja = _jnp(tree["layers"][0]["self_attn"])
    s = 10
    x = rng.standard_normal((2, s, jcfg.hidden_size)).astype(np.float32)
    g = rng.standard_normal((2, s, jcfg.hidden_size)).astype(np.float32)
    pos = np.arange(s)[None]
    jcos, jsin = jm.rope_tables(jcfg, jnp.asarray(pos), seq_len=s)
    cos, sin = modules.rope_tables(cfg, torch.from_numpy(pos), seq_len=s)
    mask = modules.causal_mask(s)

    def f(x, a, b):
        p = {**ja, "kv_b_proj": {**ja["kv_b_proj"], "lora_a": a,
                                 "lora_b": b}}
        return jm.mla_attention(jcfg, p, x, jcos, jsin,
                                jnp.asarray(mask.numpy()), method="jnp",
                                causal_prefill=True)[0]

    y, vjp = jax.vjp(f, jnp.asarray(x), ja["kv_b_proj"]["lora_a"],
                     ja["kv_b_proj"]["lora_b"])
    jgrads = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    la = pa["kv_b_proj"]["lora_a"].clone().requires_grad_()
    lb = pa["kv_b_proj"]["lora_b"].clone().requires_grad_()
    p = {**pa, "kv_b_proj": {**pa["kv_b_proj"], "lora_a": la,
                             "lora_b": lb}}
    yt, cache = modules.mla_attention(cfg, p, xt, cos, sin, mask,
                                      causal_prefill=True)
    assert cache is None
    grads = torch.autograd.grad(yt, [xt, la, lb], torch.from_numpy(g))
    close(yt.detach(), y, 1e-5)
    for got, want in zip(grads, jgrads):
        close(got, want, 1e-5)


# --------------------------------------------------------------------------
# (d) LoRA on MoE and MLA models
# --------------------------------------------------------------------------

MIXTRAL = dict(_MOE, model_type="mixtral", num_hidden_layers=2,
               num_local_experts=4, num_experts_per_tok=2)
LORA_MODELS = {
    "mixtral": (MIXTRAL, ("q_proj", "k_proj", "v_proj", "o_proj",
                          "gate_proj", "up_proj", "down_proj")),
    "deepseek_v2": (FAMILIES["deepseek_v2_q_lora"],
                    ("q_a_proj", "q_b_proj", "kv_a_proj_with_mqa",
                     "kv_b_proj", "o_proj", "down_proj")),
}


def _lora_models(name, seed=0):
    d, targets = LORA_MODELS[name]
    jcfg, cfg = _configs(d)
    tree = _quant_tree(jcfg)
    if jcfg.first_k_dense_replace:  # a dense first layer, as published
        dense = _np(jax_synth(dataclasses.replace(jcfg, num_experts=0),
                              seed=1, group_size=32, fp_dtype="float32"))
        for i in range(jcfg.first_k_dense_replace):
            tree["layers"][i]["mlp"] = dense["layers"][i]["mlp"]
    pp = from_jax_params(cfg, tree)
    jp = _jnp(tree)
    jlora.add_lora(jcfg, jp, rank=4, targets=targets, seed=seed)
    lora.add_lora(cfg, pp, rank=4, targets=targets, seed=seed)
    return jcfg, cfg, jp, pp


def _lora_paths(tree, prefix=""):
    if isinstance(tree, dict):
        if "lora_a" in tree:
            yield prefix
        for k, v in tree.items():
            yield from _lora_paths(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _lora_paths(v, f"{prefix}.{i}")


def _at(tree, path):
    for key in path.split("."):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


@pytest.mark.parametrize("name", sorted(LORA_MODELS))
def test_add_lora_on_moe_and_mla_roles_equals_jax(name):
    jcfg, cfg, jp, pp = _lora_models(name, seed=7)
    paths = list(_lora_paths(pp))
    assert paths == list(_lora_paths(jp))
    roles = {p.split(".")[-1] for p in paths}
    assert roles == set(LORA_MODELS[name][1])
    if name == "mixtral":
        assert any(".mlp.experts.3." in p for p in paths)
    else:
        assert any(".mlp.shared_experts." in p for p in paths)
        assert any(".mlp.experts." in p for p in paths)
    for path in paths:
        for leaf in ("lora_a", "lora_b"):
            got = _at(pp, path)[leaf]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(_at(jp, path)[leaf]))


@pytest.mark.parametrize("name", sorted(LORA_MODELS))
def test_three_adamw_steps_equal_jax(name):
    jcfg, cfg, jp, pp = _lora_models(name, seed=3)
    jl, jbase = jlora.split_lora(jp)
    pl, pbase = lora.split_lora(pp)
    start = [t.detach().clone() for t in tensor_leaves(pl)]
    tokens = np.random.default_rng(8).integers(0, V, (2, 12))
    jt, pt = jnp.asarray(tokens), torch.from_numpy(tokens)
    lr = 1e-2
    tx = jlora.make_optimizer("adamw", lr=lr, weight_decay=0.01)
    state = tx.init(jl)
    opt = lora.make_optimizer(pl, "adamw", lr=lr, weight_decay=0.01)
    for _ in range(3):
        jloss, jl, state = jlora.lora_train_step_optax(
            jcfg, jl, jbase, state, jt, tx)
        ploss = lora.lora_train_step_opt(cfg, pl, pbase, opt, pt)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jl)
    pleaves = tensor_leaves(pl)
    assert len(jleaves) == len(pleaves) == 2 * len(list(_lora_paths(pp)))
    moved = 0
    for got, want, s0 in zip(pleaves, jleaves, start):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=3e-3 * 3 * lr)
        moved += int(not torch.equal(got.detach(), s0))
    # an expert no token of the batch reaches keeps its adapter: every
    # other adapter trains
    assert moved >= len(pleaves) // 2


# --------------------------------------------------------------------------
# (f) expert-parallel stacks under grad
# --------------------------------------------------------------------------

def test_expert_parallel_stack_refuses_grad_as_jax():
    jcfg, cfg, jmlp, pm = _moe_layer("mixtral_softmax_renorm")
    x, _ = _moe_inputs(jcfg.hidden_size)
    # JAX: jax.grad through the stacked route's grouped kernel raises
    jst = jfuse.fuse_model(jcfg, {"layers": [{"mlp": _jnp(jmlp),
                                              "self_attn": {}}]})
    jst = jst["layers"][0]["mlp"]
    assert "experts_stacked" in jst
    with pytest.raises(NotImplementedError):
        jax.grad(lambda x: jm.moe_block(jcfg, jst, x).sum())(jnp.asarray(x))
    # the port: the same stack split over an expert axis, under grad
    st = fuse.stack_experts(cfg, pm)
    half = {name: {k: v[:2] for k, v in lin.items()}
            for name, lin in st["experts_stacked"].items()}
    ep = {**st, "experts_stacked": {**half, "tp_ep": Axis("expert", 2, 0),
                                    "ep_dispatch": "replicate"}}
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        modules.moe_block(cfg, ep, torch.from_numpy(x).requires_grad_())
    # the unsharded stack trains (the routed-rows route)
    y = modules.moe_block(cfg, st, torch.from_numpy(x).requires_grad_())
    assert y.requires_grad
