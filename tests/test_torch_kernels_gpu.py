"""The port's CUDA kernels against their plain twins on the card, at small
shapes and at TinyLlama's main-path shapes. Marked ``gpu``; each test skips
(inside the ``cuda`` fixture) when no CUDA device is present. Run on the
card, where jax is absent, with ``python -m pytest -o addopts="" --noconftest
-m gpu tests/test_torch_kernels_gpu.py`` (the repo's pytest plugin and
conftest import jax).

Tolerances, as max |kernel - twin| / max |twin|: K1 1e-2 (f32 dequant vs
the twin's bf16-rounded weights, bf16 output), K2 1e-2 (bf16 output, other
summation order), K3 2e-2 (g and u kept in f32 where the twin rounds them).
K4 2^-6 per query row and head, as max over rows of max |diff_row| /
max |twin_row| (a causal output's scale falls with the row, so a global
maximum would hide a wrong late row; both sides round to bf16, so a sound
kernel can differ by one bf16 ulp of the row maximum, up to 2^-7 of it, and
the limit is two). K5 per batch row: y 2^-6 of the row maximum (two bf16
ulps of it, as K4: one for y's own rounding, one for a flipped rounding
of the attention output carried through the o product), k_new / v_new
2^-7 per head row (one bf16 rounding of the same f32 row; f32 for an int8
cache). K6 per call 1e-2 of max |twin| (K1's arithmetic for blocks of 8
rows, K2's for larger blocks); K8 and ``moe_mlp`` 2e-2, as K3 (two
products and an activation)."""

import numpy as np
import pytest
import torch

from autoawq_tpu_torch.core.packing import pack_port
from autoawq_tpu_torch.ops import (_build, attention, fused_attn_step,
                                   fused_mlp, gemm, moe_gemm, sharded_mlp)

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    # defined here too, so the file runs with --noconftest on a machine
    # without jax (tests/conftest.py imports it)
    return np.random.default_rng(42)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def lin(rng, k, n, gs, zp, dev):
    g = k // gs
    return (pack_port(rng.integers(0, 16, (k, n))).to(dev),
            torch.from_numpy(((rng.random((g, n)) + 0.5) * 0.01).astype(
                np.float32)).to(dev),
            pack_port(rng.integers(0, 16, (g, n))).to(dev) if zp else None)


def rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("m,k,n,gs,zp", [
    (1, 64, 40, 32, True), (3, 256, 300, 64, False), (8, 2048, 2560, 128, True),
    (1, 5632, 2048, 128, True), (64, 2048, 11264, 128, True),
    (255, 2048, 2048, 32, False)])
def test_w4a16_gemv(cuda, rng, m, k, n, gs, zp):
    w = lin(rng, k, n, gs, zp, cuda)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    before = _build.LAUNCHES["w4a16_gemv"]
    got = gemm.w4a16_gemv(x, *w)
    assert _build.LAUNCHES["w4a16_gemv"] == before + 1
    assert rel(got, gemm.awq_matmul_plain(x, *w)) <= 1e-2


@pytest.mark.parametrize("m,k,n,gs,zp", [
    (256, 64, 40, 32, True), (300, 256, 2500, 64, False),
    (768, 2048, 11264, 128, True), (256, 5632, 2048, 128, True)])
def test_w4a16_gemm(cuda, rng, m, k, n, gs, zp):
    w = lin(rng, k, n, gs, zp, cuda)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    got = gemm.w4a16_gemm(x, *w)
    assert rel(got, gemm.awq_matmul_plain(x, *w)) <= 1e-2


def test_dispatcher_routes_by_m(cuda, rng):
    w = lin(rng, 256, 128, 64, True, cuda)
    _build.reset_launches()
    gemm.awq_matmul(torch.randn(2, 5, 256, device=cuda).to(torch.bfloat16),
                    *w)
    gemm.awq_matmul(torch.randn(2, 128, 256, device=cuda).to(torch.bfloat16),
                    *w)
    assert _build.LAUNCHES["w4a16_gemv"] == 1
    assert _build.LAUNCHES["w4a16_gemm"] == 1


@pytest.mark.parametrize("m,h,inter,act", [
    (1, 256, 512, "silu"), (5, 256, 768, "gelu_pytorch_tanh"),
    (8, 2048, 5632, "silu"), (32, 2048, 5632, "gelu")])
def test_fused_mlp(cuda, rng, m, h, inter, act):
    gu = lin(rng, h, 2 * inter, 128, True, cuda)
    dn = lin(rng, inter, h, 128, True, cuda)
    x = (torch.randn(m, h, device=cuda) * 0.5).to(torch.bfloat16)
    args = (x, gu[0], gu[1], dn[0], dn[1], gu[2], dn[2])
    got = fused_mlp.fused_mlp(*args, inter=inter, act=act)
    ref = fused_mlp.fused_mlp_plain(*args, inter=inter, act=act)
    assert rel(got, ref) <= 2e-2


def row_rel(a, b, hd):
    d = (a.float() - b.float()).reshape(-1, hd).abs().amax(-1)
    return (d / b.float().reshape(-1, hd).abs().amax(-1)).max().item()


@pytest.mark.parametrize("b,s,nh,nkv,hd", [
    (1, 130, 4, 2, 64), (2, 384, 32, 4, 64), (1, 200, 8, 8, 128),
    (1, 150, 4, 2, 96), (1, 140, 4, 1, 256)])
def test_prefill_attention(cuda, b, s, nh, nkv, hd):
    q = torch.randn(b, s, nh, hd, device=cuda).to(torch.bfloat16)
    kv = torch.randn(b, s, 2 * nkv, hd, device=cuda).to(torch.bfloat16)
    k, v = kv[:, :, :nkv], kv[:, :, nkv:]  # strided views, as from a fused qkv
    before = _build.LAUNCHES["prefill_attention"]
    got = attention.prefill_attention(q, k, v, hd ** -0.5)
    assert _build.LAUNCHES["prefill_attention"] == before + 1
    ref = attention.prefill_attention_plain(q, k, v, hd ** -0.5)
    assert got.shape == ref.shape
    assert row_rel(got, ref, hd) <= 2 ** -6


def k5_inputs(rng, dev, b, nh, nkv, hd, h, t, int8, bias=False):
    """Random int4 qkv / o (g128, zero points), x, a cache of capacity t and
    the rope rows of one position, on the card."""
    qkv = dict(zip(("qweight", "scales", "qzeros"),
                   lin(rng, h, (nh + 2 * nkv) * hd, 128, True, dev)))
    o = dict(zip(("qweight", "scales", "qzeros"),
                 lin(rng, nh * hd, h, 128, True, dev)))
    if bias:
        qkv["bias"] = torch.randn((nh + 2 * nkv) * hd, device=dev).to(
            torch.bfloat16)
    x = (torch.randn(b, h, device=dev) * 0.5).to(torch.bfloat16)
    kc, vc = (torch.randn(b, nkv, t, hd, device=dev) * 0.5 for _ in range(2))
    scales = {}
    if int8:
        kc, vc = (c.mul(40).round().clamp(-127, 127).to(torch.int8)
                  for c in (kc, vc))
        scales = {"k_scales": torch.rand(b, nkv, t, device=dev) * 0.02,
                  "v_scales": torch.rand(b, nkv, t, device=dev) * 0.02}
    else:
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    ang = 7.0 * torch.arange(hd // 2, device=dev) / hd
    return (x, qkv, o, kc, vc, torch.cos(ang)[None], torch.sin(ang)[None],
            scales)


@pytest.mark.parametrize("b,nh,nkv,hd,h,t,vl,window,int8,bias", [
    (8, 32, 8, 128, 4096, 128, 127, None, False, False),    # Mistral, C
    (8, 32, 8, 128, 4096, 2112, 2111, None, True, False),   # Mistral, D
    (8, 32, 4, 64, 2048, 128, 127, None, False, False),     # TinyLlama, rep 8
    (1, 32, 8, 128, 4096, 128, 0, None, False, False),      # vl = 0
    (8, 32, 8, 128, 4096, 2112, 2000, 1024, False, False),  # window
    (2, 28, 4, 128, 3584, 200, 150, None, False, True),     # qkv bias, rep 7
    (2, 8, 8, 96, 768, 80, 77, None, True, False),          # MHA, hd 96
])
def test_fused_attn_step(cuda, rng, b, nh, nkv, hd, h, t, vl, window, int8,
                         bias):
    x, qkv, o, kc, vc, cos, sin, sc = k5_inputs(rng, cuda, b, nh, nkv, hd, h,
                                                t, int8, bias)
    kw = dict(nh=nh, nkv=nkv, hd=hd, scale=hd ** -0.5, window=window, **sc)
    before = _build.LAUNCHES["fused_attn_step"]
    y, k, v = fused_attn_step.fused_attention_step(x, qkv, o, kc, vc, cos,
                                                   sin, vl, **kw)
    assert _build.LAUNCHES["fused_attn_step"] == before + 1
    ry, rk, rv = fused_attn_step.fused_attention_step_plain(
        x, qkv, o, kc, vc, cos, sin, vl, **kw)
    assert k.dtype == rk.dtype == (torch.float32 if int8 else torch.bfloat16)
    assert row_rel(y, ry, h) <= 2 ** -6
    assert row_rel(k, rk, hd) <= 2 ** -7 and row_rel(v, rv, hd) <= 2 ** -7


def test_fused_attn_step_rejects(cuda, rng):
    x, qkv, o, kc, vc, cos, sin, _ = k5_inputs(rng, cuda, 2, 4, 2, 64, 256,
                                               64, False)
    kw = dict(nh=4, nkv=2, hd=64, scale=0.125)
    with pytest.raises(ValueError):  # an f32 cache is not a K5 cache
        fused_attn_step.fused_attention_step(x, qkv, o, kc.float(),
                                             vc.float(), cos, sin, 3, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fused_attn_step.fused_attention_step(
            x, qkv, o, kc, vc, cos, sin, 3, **dict(kw, hd=320))


def test_wrappers_reject_what_kernels_do_not_take(cuda, rng):
    w = lin(rng, 256, 64, 64, True, cuda)
    with pytest.raises(TypeError):
        gemm.w4a16_gemv(torch.randn(2, 256, device=cuda), *w)  # f32 x
    with pytest.raises(ValueError):
        gemm.w4a16_gemm(torch.randn(256, 2, device=cuda).to(
            torch.bfloat16).t(), *w)  # not contiguous
    w32 = lin(rng, 256, 64, 16, True, cuda)  # K2 needs groups of 32
    with pytest.raises(ValueError):
        gemm.w4a16_gemm(torch.randn(256, 256, device=cuda).to(
            torch.bfloat16), *w32)


def stack(gen, e, k, n, gs, zp, dev):
    """A random [E, K/8, N] expert stack in the port's layout, on the card
    (a full Mixtral stack is too large to draw with numpy quickly)."""
    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                             device=dev, generator=gen).to(torch.int32)
    g = k // gs
    return {"qweight": words(e, k // 8, n),
            "scales": (torch.rand(e, g, n, device=dev, generator=gen) + 0.5)
            * 0.01,
            "qzeros": words(e, -(-g // 8), n) if zp else None}


def routed(gen, t, e, k, dev):
    """k distinct experts per token, as a router's top-k picks them."""
    return torch.rand(t, e, device=dev, generator=gen).topk(k, -1).indices


@pytest.mark.parametrize("t,k_dim,n,gs,zp", [
    (1, 4096, 28672, 128, True),    # E's decode, gate_up (bm 8)
    (1, 14336, 4096, 128, True),    # E's decode, down
    (8, 4096, 28672, 128, True),    # F's decode (16 entries)
    (3, 256, 192, 64, False),       # dead blocks, symmetric, g64
    (40, 512, 384, 32, True),       # bm 8 at 80 entries over 8 experts
    (200, 512, 384, 64, True),      # bm 8 -> pick_block_m 8: 400 / 32
    (512, 1024, 640, 128, True),    # bm 32: the 32-row tile
    (1536, 1024, 640, 128, False),  # bm 96: the 128-row tile, masked
    (4096, 4096, 28672, 128, True),  # F's prefill, gate_up (bm 128)
])
def test_moe_gemm(cuda, t, k_dim, n, gs, zp):
    gen = torch.Generator(device=cuda).manual_seed(t + n)
    e, k = 8, 2
    w = stack(gen, e, k_dim, n, gs, zp, cuda)
    topi = routed(gen, t, e, k, cuda)
    bm = moe_gemm.pick_block_m(t * k, e)
    gather_idx, block_expert, live, _ = moe_gemm.moe_align(topi, e, bm)
    x = (torch.randn(t, k_dim, device=cuda, generator=gen) * 0.5).to(
        torch.bfloat16)
    xz = torch.cat([x, x.new_zeros((1, k_dim))])
    xs = xz[torch.clamp(gather_idx.long() // k, max=t)]
    args = (xs, block_expert, w["qweight"], w["scales"], w["qzeros"])
    before = _build.LAUNCHES["moe_gemm"]
    got = moe_gemm.grouped_awq_matmul(*args, block_m=bm, live_blocks=live,
                                      max_live=t * k)
    assert _build.LAUNCHES["moe_gemm"] == before + 1
    ref = moe_gemm.grouped_awq_matmul_plain(*args, block_m=bm,
                                            live_blocks=live)
    assert rel(got, ref) <= 1e-2
    dead = int(live) * bm  # rows of the trailing dead blocks: zero
    assert not got[dead:].any()


def test_moe_gemm_rejects(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = stack(gen, 4, 256, 64, 16, True, cuda)
    be = torch.zeros(2, dtype=torch.int32, device=cuda)
    live = torch.full((1,), 2, dtype=torch.int32, device=cuda)
    xs = torch.randn(32, 256, device=cuda)
    kw = dict(block_m=16, live_blocks=live, max_live=32)
    with pytest.raises(TypeError):  # f32 activations
        moe_gemm.grouped_awq_matmul(xs, be, w["qweight"], w["scales"],
                                    w["qzeros"], **kw)
    with pytest.raises(ValueError):  # the tile path needs groups of 32
        moe_gemm.grouped_awq_matmul(xs.to(torch.bfloat16), be, w["qweight"],
                                    w["scales"], w["qzeros"], **kw)
    with pytest.raises(ValueError):  # one expert per token block
        moe_gemm.grouped_awq_matmul(xs.to(torch.bfloat16), be[:1],
                                    w["qweight"], w["scales"], w["qzeros"],
                                    **kw)


@pytest.mark.parametrize("t,e,k", [(1, 8, 2), (8, 8, 2), (64, 8, 2),
                                   (4096, 8, 2), (300, 5, 3)])
def test_moe_align_on_card_equals_cpu(cuda, t, e, k):
    """The routing tables the card's main path builds (stable argsort,
    scatters, searchsorted on CUDA) equal the CPU's bit for bit; the CPU's
    are held against JAX's in tests/test_torch_moe.py."""
    gen = torch.Generator(device=cuda).manual_seed(t)
    topi = routed(gen, t, e, k, cuda)
    bm = moe_gemm.pick_block_m(t * k, e)
    on_card = moe_gemm.moe_align(topi, e, bm)
    on_cpu = moe_gemm.moe_align(topi.cpu(), e, bm)
    for name, a, b in zip(("gather_idx", "block_expert", "live_blocks",
                           "entry_rows"), on_card, on_cpu):
        assert a.is_cuda and a.dtype == b.dtype, name
        assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("t", [1, 8, 300])
def test_moe_mlp(cuda, t):
    gen = torch.Generator(device=cuda).manual_seed(t)
    e, k, h, inter = 8, 2, 1024, 1536
    stacked = {"gate_up_proj": stack(gen, e, h, 2 * inter, 128, True, cuda),
               "down_proj": stack(gen, e, inter, h, 128, True, cuda)}
    x = (torch.randn(t, h, device=cuda, generator=gen) * 0.5).to(
        torch.bfloat16)
    topi = routed(gen, t, e, k, cuda)
    topw = torch.rand(t, k, device=cuda, generator=gen)
    _build.reset_launches()
    got = moe_gemm.moe_mlp(stacked, x, topw, topi, "silu", inter)
    assert _build.LAUNCHES["moe_gemm"] == 2
    ref = moe_gemm.moe_mlp(stacked, x, topw, topi, "silu", inter,
                           method="plain")
    assert rel(got, ref) <= 2e-2


@pytest.mark.parametrize("m,h,inter,act,zp", [
    (1, 2048, 5632, "silu", (True, True, True)),     # TinyLlama, M=1
    (8, 2048, 5632, "silu", (True, True, True)),     # TinyLlama, M=8
    (1, 4096, 14336, "silu", (True, True, True)),    # a Mixtral expert
    (3, 256, 768, "gelu_pytorch_tanh", (False, False, False)),
    (32, 512, 1024, "gelu", (True, False, True)),    # mixed zeros
])
def test_fused_mlp3(cuda, rng, m, h, inter, act, zp):
    g = lin(rng, h, inter, 128, zp[0], cuda)
    u = lin(rng, h, inter, 128, zp[1], cuda)
    d = lin(rng, inter, h, 128, zp[2], cuda)
    x = (torch.randn(m, h, device=cuda) * 0.5).to(torch.bfloat16)
    args = (x, g[0], g[1], u[0], u[1], d[0], d[1], g[2], u[2], d[2])
    before = _build.LAUNCHES["fused_mlp3"]
    got = sharded_mlp.fused_mlp3(*args, inter=inter, act=act)
    assert _build.LAUNCHES["fused_mlp3"] == before + 1
    ref = sharded_mlp.fused_mlp3_plain(*args, inter=inter, act=act)
    assert rel(got, ref) <= 2e-2


def test_fused_mlp3_rejects(cuda, rng):
    g = lin(rng, 256, 512, 64, True, cuda)
    d = lin(rng, 512, 256, 64, True, cuda)
    x = torch.randn(33, 256, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):  # M > 32
        sharded_mlp.fused_mlp3(x, g[0], g[1], g[0], g[1], d[0], d[1], g[2],
                               g[2], d[2], inter=512)
    with pytest.raises(ValueError):  # relu is not a K8 activation
        sharded_mlp.fused_mlp3(x[:2], g[0], g[1], g[0], g[1], d[0], d[1],
                               g[2], g[2], d[2], inter=512, act="relu")


def tiny_mixtral(rng, gen, dev):
    """A 2-layer Mixtral-shaped model (8 experts, top-2) on the card: fused
    qkv, stacked experts, random int4 weights."""
    from autoawq_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(model_type="mixtral", vocab_size=256, hidden_size=512,
                      intermediate_size=1024, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=2,
                      head_dim=64, num_experts=8, num_experts_per_tok=2)
    bf = torch.bfloat16

    def qlin(k, n):
        return dict(zip(("qweight", "scales", "qzeros"),
                        lin(rng, k, n, 128, True, dev)))

    def ones():
        return {"weight": torch.ones(512, dtype=bf, device=dev)}
    layers = [{"input_layernorm": ones(), "post_attention_layernorm": ones(),
               "self_attn": {"qkv_proj": qlin(512, 768),
                             "o_proj": qlin(512, 512)},
               "mlp": {"gate": {"kernel": torch.randn(
                   512, 8, device=dev, generator=gen).to(bf)},
                       "experts_stacked": {
                           "gate_up_proj": stack(gen, 8, 512, 2048, 128,
                                                 True, dev),
                           "down_proj": stack(gen, 8, 1024, 512, 128, True,
                                              dev)}}} for _ in range(2)]
    params = {"embed_tokens": {"weight": torch.randn(
        256, 512, device=dev, generator=gen).to(bf)}, "norm": ones(),
        "lm_head": {"kernel": (torch.randn(512, 256, device=dev,
                                           generator=gen) * 0.05).to(bf)},
        "layers": layers}
    return cfg, params


@pytest.mark.parametrize("b,s", [(1, 64), (8, 40)])
def test_moe_prefill_and_decode_never_sync_the_host(cuda, rng, b, s):
    """The MoE block (router, moe_align, two K6 calls, the combine) and the
    prefill and decode steps around it never wait for the card: under
    ``torch.cuda.set_sync_debug_mode("error")`` any synchronizing call
    (``.item()``, ``nonzero``, a device-to-host copy) raises. B = 8 also
    takes K5."""
    from autoawq_tpu_torch.serve import generate as gen

    g = torch.Generator(device=cuda).manual_seed(b)
    cfg, params = tiny_mixtral(rng, g, cuda)
    prompt = torch.randint(0, 256, (b, s), device=cuda, generator=g)
    token = prompt[:, -1:]
    caches = [gen.init_kv_cache(cfg, b, 128, device=cuda) for _ in range(2)]
    gen.prefill(cfg, params, prompt, caches[0])  # builds, caches rope
    gen.decode_step(cfg, params, token, caches[0], s)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen.prefill(cfg, params, prompt, caches[1])
        logits, _ = gen.decode_step(cfg, params, token, caches[1], s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.LAUNCHES["moe_gemm"] == 8  # 2 layers x 2, twice
    assert _build.LAUNCHES["fused_attn_step"] == (2 if b == 8 else 0)
    assert bool(torch.isfinite(logits).all())
