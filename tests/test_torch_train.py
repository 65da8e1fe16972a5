"""Training in the port held against the JAX package on the CPU: the W4A16
linear's input gradient, the prefill attention's q/k/v gradients, LoRA's
adapters and steps, and the tiny pretraining recipe. Inputs are seeded
numpy arrays (JAX ``utils/synth`` weights carried over by
``convert.from_jax_params``); everything runs in f32.

Tolerances:

* gradients (W4A16 dx, attention dq / dk / dv, adapter gradients): within
  1e-5 of the JAX tensor's largest magnitude; f32 sums taken in other
  orders;
* the adapters' ``add_lora`` draws and ``split_lora`` / ``merge_lora``
  trees: equal;
* losses and adapters after 3 SGD or 3 AdamW steps: losses within 1e-5
  relative; adapters within 5e-5 of their largest magnitude after SGD
  (each step's gradients differ by f32 summation order, ~1e-6 of their
  scale, and the steps carry that into the next gradients); after AdamW
  within 3e-3 of the most three steps can move an entry (3 lr; a wrong
  moment, bias correction or decay moves entries by ~lr): AdamW
  divides each entry's step by that entry's own gradient scale, so an
  entry with a small gradient carries the same absolute difference into
  its update at full relative size, and optax and torch round the formula
  at other points;
* ``synth_corpus``: bit-equal; ``train_tiny``: its 5 printed losses equal
  JAX's to the 4 printed decimals (within one unit of the last), its
  final loss within 1e-5 relative and its parameters within 1e-4 of each
  tensor's largest magnitude (5 AdamW steps at lr 3e-3 normalise f32
  gradient differences of ~1e-6 into updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from autoawq_tpu.models.config import ModelConfig as JaxConfig
from autoawq_tpu.nn import modules as jm
from autoawq_tpu.ops import gemm as jgemm
from autoawq_tpu.train import lora as jlora
from autoawq_tpu.train import pretrain as jpre
from autoawq_tpu.utils.synth import random_quantized_params as jax_synth
from autoawq_tpu_torch.convert import from_jax_params
from autoawq_tpu_torch.models.config import ModelConfig
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.ops import _build, attention as at
from autoawq_tpu_torch.ops import fused_attn_step as fas
from autoawq_tpu_torch.ops import fused_mlp, gemm, moe_gemm, paged_attn
from autoawq_tpu_torch.ops import sharded_mlp
from autoawq_tpu_torch.train import lora, pretrain
from autoawq_tpu_torch.utils.tree import tensor_leaves

KW = dict(model_type="llama", vocab_size=128, hidden_size=128,
          intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, head_dim=32, max_position_embeddings=64)
TINY = dict(model_type="llama", vocab_size=64, hidden_size=32,
            intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8, max_position_embeddings=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def models(seed=0, gs=64, zero_point=True):
    jcfg, cfg = JaxConfig(**KW), ModelConfig(**KW)
    jp = _np(jax_synth(jcfg, seed=seed, group_size=gs,
                       zero_point=zero_point))
    return jcfg, cfg, jp, from_jax_params(cfg, jp)


# ------------------------------------------------------------ gradients

@pytest.mark.parametrize("role,zero_point", [
    ("self_attn.q_proj", True), ("mlp.down_proj", True),
    ("self_attn.k_proj", False)])
def test_w4a16_dx_equals_jax_vjp(rng, role, zero_point):
    jcfg, cfg, jp, pp = models(zero_point=zero_point)
    attn_or_mlp, name = role.split(".")
    jlin = jp["layers"][0][attn_or_mlp][name]
    plin = pp["layers"][0][attn_or_mlp][name]
    n = {"q_proj": 128, "k_proj": 64, "down_proj": 128}[name]
    k = 8 * plin["qweight"].shape[0]
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    g = rng.standard_normal((2, 5, n)).astype(np.float32)

    def f(xx):
        return jgemm.awq_matmul(xx, jnp.asarray(jlin["qweight"]),
                                jnp.asarray(jlin["scales"]),
                                None if jlin.get("qzeros") is None
                                else jnp.asarray(jlin["qzeros"]),
                                out_features=n, method="jnp")
    y, vjp = jax.vjp(f, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))

    args = (plin["qweight"], plin["scales"], plin.get("qzeros"))
    # the kernel route's Function (its forward runs the twin on the CPU)
    xt = torch.from_numpy(x).requires_grad_()
    yt = gemm.AwqMatmulFn.apply(xt, *args, n)
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    close(yt.detach(), y, 1e-5)
    close(got, want, 1e-5)
    # the twin, through autograd
    xt = torch.from_numpy(x).requires_grad_()
    yt = gemm.awq_matmul(xt, *args, out_features=n, method="plain")
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    close(got, want, 1e-5)


def _jax_reference_attention(q, k, v, scale):
    """jax's stock kernel's own oracle, ``mha_reference`` (its custom VJP:
    ``mha_reference_bwd``), behind ``_flash_prefill``'s ``jnp.repeat``;
    ``mha_reference_bwd`` takes sm_scale 1 only, so q is scaled first."""
    b, s, nh, hd = q.shape
    rep = nh // k.shape[2]
    kr = jnp.repeat(k, rep, axis=2)
    vr = jnp.repeat(v, rep, axis=2)
    out = jfa.mha_reference((q * scale).swapaxes(1, 2), kr.swapaxes(1, 2),
                            vr.swapaxes(1, 2), None, causal=True,
                            sm_scale=1.0)
    return out.swapaxes(1, 2).reshape(b, s, nh * hd)


@pytest.mark.parametrize("b,s,nh,nkv,hd", [(2, 16, 4, 2, 16),
                                           (1, 24, 4, 4, 8),
                                           (2, 12, 8, 2, 32)])
def test_attention_grads_equal_mha_reference(rng, b, s, nh, nkv, hd):
    q = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, hd)).astype(np.float32)
    g = rng.standard_normal((b, s, nh * hd)).astype(np.float32)
    scale = hd ** -0.5
    out, vjp = jax.vjp(lambda a, c, d: _jax_reference_attention(
        a, c, d, scale), *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got_out = at.prefill_attention(*ts, scale)
    got = torch.autograd.grad(got_out, ts, torch.from_numpy(g))
    close(got_out.detach(), out, 1e-5)
    for gt, wt in zip(got, want):
        close(gt, wt, 1e-5)


def test_attention_layer_grads_equal_jax(rng):
    """x and LoRA-adapter gradients through one whole attention layer (q, k,
    v and o int4 with adapters, RoPE, GQA, the causal prefill route)
    against ``jax.vjp`` of JAX's ``modules.attention``."""
    jcfg, cfg, jp, pp = models(seed=3)
    jlp = jax.tree_util.tree_map(jnp.asarray, jp)
    jlora.add_lora(jcfg, jlp, rank=4, seed=5)
    lora.add_lora(cfg, pp, rank=4, seed=5)
    for name in ("q_proj", "o_proj"):  # nonzero B, so A gets a gradient
        bmat = rng.standard_normal((4, 128)).astype(np.float32) * 0.1
        jlp["layers"][0]["self_attn"][name]["lora_b"] = jnp.asarray(bmat)
        pp["layers"][0]["self_attn"][name]["lora_b"] = torch.from_numpy(bmat)
    s = 16
    x = rng.standard_normal((2, s, 128)).astype(np.float32)
    g = rng.standard_normal((2, s, 128)).astype(np.float32)
    pos = np.arange(s)[None]
    jcos, jsin = jm.rope_tables(jcfg, jnp.asarray(pos), seq_len=s)
    jmask = jm.causal_mask(s)
    jattn = jlp["layers"][0]["self_attn"]
    jl, jbase = jlora.split_lora(jattn)

    def f(xx, lo):
        y, _ = jm.attention(jcfg, jlora.merge_lora(lo, jbase), xx, jcos,
                            jsin, jmask, method="jnp", causal_prefill=True)
        return y
    y, vjp = jax.vjp(f, jnp.asarray(x), jl)
    jdx, jdl = vjp(jnp.asarray(g))

    cos, sin = modules.rope_tables(cfg, torch.from_numpy(pos), seq_len=s)
    mask = modules.causal_mask(s)
    pl, pbase = lora.split_lora(pp["layers"][0]["self_attn"])
    xt = torch.from_numpy(x).requires_grad_()
    yt, _ = modules.attention(cfg, lora.merge_lora(pl, pbase), xt, cos, sin,
                              mask, causal_prefill=True)
    leaves = tensor_leaves(pl)
    grads = torch.autograd.grad(yt, [xt] + leaves, torch.from_numpy(g))
    close(yt.detach(), y, 1e-5)
    close(grads[0], jdx, 1e-5)
    jleaves = jax.tree_util.tree_leaves(jdl)
    assert len(jleaves) == len(leaves) == 8
    for gt, wt in zip(grads[1:], jleaves):
        close(gt, wt, 1e-5)


# ------------------------------------------------------------ LoRA trees

def test_add_split_merge_lora_equal_jax():
    jcfg, cfg, jp, pp = models(seed=1)
    jlora.add_lora(jcfg, jp, rank=8, alpha=16.0, seed=7)
    lora.add_lora(cfg, pp, rank=8, alpha=16.0, seed=7)
    jl, jbase = jlora.split_lora(jp)
    pl, pbase = lora.split_lora(pp)
    for li in range(2):
        for name in lora.DEFAULT_TARGETS:
            for leaf in ("lora_a", "lora_b"):
                got = pl["layers"][li]["self_attn"][name][leaf]
                want = np.asarray(jl["layers"][li]["self_attn"][name][leaf])
                assert got.dtype == torch.float32 and got.requires_grad
                assert got.is_leaf
                np.testing.assert_array_equal(got.detach().numpy(), want)
                assert leaf not in pbase["layers"][li]["self_attn"][name]
    assert "mlp" not in pl["layers"][0]  # no adapters outside the targets
    merged = lora.merge_lora(pl, pbase)
    for li in range(2):
        for name in lora.DEFAULT_TARGETS:
            lin = merged["layers"][li]["self_attn"][name]
            assert lin["lora_a"] is pl["layers"][li]["self_attn"][name][
                "lora_a"]
            assert lin["qweight"] is pp["layers"][li]["self_attn"][name][
                "qweight"]


# ------------------------------------------------------------ steps

@pytest.mark.parametrize("opt_name,lr", [("sgd", 0.5), ("adamw", 1e-2)])
def test_three_steps_equal_jax(rng, opt_name, lr):
    jcfg, cfg, jp, pp = models(seed=2)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    jlora.add_lora(jcfg, jp, rank=4, seed=3)
    lora.add_lora(cfg, pp, rank=4, seed=3)
    jl, jbase = jlora.split_lora(jp)
    pl, pbase = lora.split_lora(pp)
    start = [t.detach().clone() for t in tensor_leaves(pl)]
    tokens = rng.integers(0, KW["vocab_size"], (2, 16))
    jt, pt = jnp.asarray(tokens), torch.from_numpy(tokens)
    if opt_name == "sgd":
        for _ in range(3):
            jloss, jl = jlora.lora_train_step(jcfg, jl, jbase, jt, lr=lr)
            ploss, pl = lora.lora_train_step(cfg, pl, pbase, pt, lr=lr)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=1e-5)
    else:
        tx = jlora.make_optimizer("adamw", lr=lr, weight_decay=0.01)
        state = tx.init(jl)
        opt = lora.make_optimizer(pl, "adamw", lr=lr, weight_decay=0.01)
        for _ in range(3):
            jloss, jl, state = jlora.lora_train_step_optax(
                jcfg, jl, jbase, state, jt, tx)
            ploss = lora.lora_train_step_opt(cfg, pl, pbase, opt, pt)
            np.testing.assert_allclose(float(ploss), float(jloss),
                                       rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jl)
    pleaves = tensor_leaves(pl)
    assert len(jleaves) == len(pleaves) == 16
    moved = 0
    for got, want, s0 in zip(pleaves, jleaves, start):
        if opt_name == "sgd":
            close(got.detach(), want, 5e-5)
        else:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=0, atol=3e-3 * 3 * lr)
        moved += int(not torch.equal(got.detach(), s0))
    assert moved == 16  # every adapter trained


# ------------------------------------------------------------ pretraining

def test_synth_corpus_bit_equal():
    for vocab, n, seed in ((64, 5000, 0), (997, 3000, 4)):
        np.testing.assert_array_equal(pretrain.synth_corpus(vocab, n, seed),
                                      jpre.synth_corpus(vocab, n, seed))


def _printed_losses(text):
    return [float(ln.split()[-1]) for ln in text.splitlines()
            if ln.startswith("step ")]


def test_train_tiny_losses_equal_jax(capsys):
    corpus = pretrain.synth_corpus(TINY["vocab_size"], 4000, seed=1)
    kw = dict(steps=5, batch=4, seq=32, lr=3e-3, seed=0, log_every=1)
    jparams, jloss = jpre.train_tiny(JaxConfig(**TINY), corpus, **kw)
    jout = capsys.readouterr().out
    params, loss = pretrain.train_tiny(ModelConfig(**TINY), corpus,
                                       device="cpu", **kw)
    pout = capsys.readouterr().out
    want, got = _printed_losses(jout), _printed_losses(pout)
    assert len(want) == len(got) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)
    assert got[-1] < got[0]
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    close(params["embed_tokens"]["weight"],
          jparams["embed_tokens"]["weight"], 1e-4)
    for li in range(2):
        for path in (("self_attn", "q_proj"), ("mlp", "down_proj")):
            close(params["layers"][li][path[0]][path[1]]["kernel"],
                  jparams["layers"][li][path[0]][path[1]]["kernel"], 1e-4)
        close(params["layers"][li]["input_layernorm"]["weight"],
              jparams["layers"][li]["input_layernorm"]["weight"], 1e-4)


def test_roughen_activations_equal_jax():
    from autoawq_tpu.io.hf import init_random_params as jax_init
    from autoawq_tpu_torch.io.hf import init_random_params

    jcfg, cfg = JaxConfig(**TINY), ModelConfig(**TINY)
    jparams = jpre.roughen_activations(jcfg, _np(jax_init(jcfg, seed=2)),
                                       n_channels=4, scale=8.0)
    params = pretrain.roughen_activations(
        cfg, init_random_params(cfg, seed=2, device="cpu"), n_channels=4,
        scale=8.0)
    for li in range(2):
        lp, jlp = params["layers"][li], jparams["layers"][li]
        for norm in ("input_layernorm", "post_attention_layernorm"):
            np.testing.assert_array_equal(lp[norm]["weight"].numpy(),
                                          np.asarray(jlp[norm]["weight"]))
        for sub, name in (("self_attn", "q_proj"), ("mlp", "up_proj")):
            np.testing.assert_array_equal(
                lp[sub][name]["kernel"].numpy(),
                np.asarray(jlp[sub][name]["kernel"]))


# ------------------------------------------------------------ refusals

def _lin(k, n, gs=32):
    g = np.random.default_rng(0)
    from autoawq_tpu_torch.core.packing import pack_port
    return {"qweight": pack_port(g.integers(0, 16, (k, n))),
            "scales": torch.full((k // gs, n), 0.01),
            "qzeros": pack_port(g.integers(0, 16, (k // gs, n)))}


def _no_backward_calls():
    h, inter = 64, 64
    gu, dn, gate, up = (_lin(h, 2 * inter), _lin(inter, h), _lin(h, inter),
                        _lin(h, inter))
    x = torch.randn(1, h, requires_grad=True)
    pages = torch.randn(2, 4, 16, 32)
    table = torch.zeros((1, 2), dtype=torch.int32)
    lengths = torch.tensor([5], dtype=torch.int32)
    q = torch.randn(1, 4, 32, requires_grad=True)
    stacked = {k: torch.stack([v, v]) for k, v in gu.items()}
    return {
        "w4a16_gemv": lambda: gemm.w4a16_gemv(
            x, gate["qweight"], gate["scales"], gate["qzeros"]),
        "w4a16_gemm": lambda: gemm.w4a16_gemm(
            x, gate["qweight"], gate["scales"], gate["qzeros"]),
        "fused_mlp": lambda: fused_mlp.fused_mlp(
            x, gu["qweight"], gu["scales"], dn["qweight"], dn["scales"],
            gu["qzeros"], dn["qzeros"], inter=inter, act="silu"),
        "fused_mlp3": lambda: sharded_mlp.fused_mlp3(
            x, gate["qweight"], gate["scales"], up["qweight"], up["scales"],
            dn["qweight"], dn["scales"], inter=inter, act="silu"),
        "fused_attn_step": lambda: fas.fused_attention_step(
            x, {}, {}, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16),
            torch.ones(1, 8), torch.zeros(1, 8), 3, nh=4, nkv=2, hd=16,
            scale=0.25),
        "moe_gemm": lambda: moe_gemm.grouped_awq_matmul(
            x.expand(8, h), torch.zeros(1, dtype=torch.int32),
            stacked["qweight"], stacked["scales"], stacked["qzeros"],
            block_m=8, live_blocks=torch.ones(1, dtype=torch.int32),
            max_live=8),
        "paged_attn": lambda: paged_attn.paged_decode_attention(
            q, pages, pages, table, lengths, scale=0.2),
        "paged_attn_stock": lambda: paged_attn.stock_paged_attention(
            q, pages, pages, lengths, table, pages_per_compute_block=1),
    }


@pytest.mark.parametrize("name", sorted(_no_backward_calls()))
def test_wrappers_without_backward_raise_on_grad(name):
    call = _no_backward_calls()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    with torch.no_grad():  # the same call without grad gets past the check
        try:
            call()
        except RuntimeError as e:
            assert "requires grad" not in str(e)
        except (ValueError, TypeError, IndexError, KeyError):
            pass


def test_gates_refuse_inputs_that_require_grad():
    from autoawq_tpu_torch.nn import fuse

    jcfg, cfg, jp, pp = models(seed=4)
    lp = fuse.fuse_model(cfg, models(seed=4)[3])["layers"][0]
    x = torch.randn(1, 1, 128)
    assert modules._fused_mlp_ok(cfg, lp["mlp"], x, "auto", 256)
    assert modules._sharded_mlp_ok(cfg, pp["layers"][0]["mlp"], x, "auto",
                                   256)
    xg = x.clone().requires_grad_()
    assert not modules._fused_mlp_ok(cfg, lp["mlp"], xg, "auto", 256)
    assert not modules._sharded_mlp_ok(cfg, pp["layers"][0]["mlp"], xg,
                                       "auto", 256)
    cache = {"k": torch.zeros(8, 2, 64, 32), "v": torch.zeros(8, 2, 64, 32),
             "pos": 3}
    x8 = torch.randn(8, 1, 128)
    assert modules._fused_attn_ok(cfg, lp["self_attn"], x8, "auto", cache)
    assert not modules._fused_attn_ok(cfg, lp["self_attn"],
                                      x8.requires_grad_(), "auto", cache)
    # the decode MLP under grad takes the differentiable chain, with the
    # twin's values
    with torch.no_grad():
        want = modules.mlp(cfg, lp["mlp"], x)
    got = modules.mlp(cfg, lp["mlp"], xg)
    assert got.requires_grad
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-5)


def test_launch_counts_are_untouched_on_the_cpu():
    before = dict(_build.LAUNCHES)
    jcfg, cfg, jp, pp = models(seed=6)
    lora.add_lora(cfg, pp, rank=2)
    pl, pbase = lora.split_lora(pp)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    lora.lora_loss_and_grads(cfg, pl, pbase, tokens)
    assert _build.LAUNCHES == before
