"""The port's CUDA kernels against their plain twins on the card, at small
shapes and at TinyLlama's main-path shapes. Marked ``gpu``; each test skips
(inside the ``cuda`` fixture) when no CUDA device is present. Run on the
card, where jax is absent, with ``python -m pytest -o addopts="" --noconftest
-m gpu tests/test_torch_kernels_gpu.py`` (the repo's pytest plugin and
conftest import jax).

Tolerances, as max |kernel - twin| / max |twin|: K1 1e-2 (f32 dequant vs
the twin's bf16-rounded weights, bf16 output), K2 1e-2 (bf16 output, other
summation order; K1 keeps q - z exact and scales each group's f32 sum, the
twin rounds (q - z) * s to bf16), K3 2e-2 (g and u kept in f32 where the twin rounds them).
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
products and an activation). K7 per (slot, head) row at 1e-4 of the row
maximum: it returns f32 and computes the twin's f32 function, so only the
order of the sums differs (online softmaxes over splits, merged, against
one softmax), plus the ~2^-17 residual of q and p split into bf16 hi + lo
parts on the tensor cores. K9 per row at 2^-6, two bf16 ulps of the row
maximum: both round
the f32 result to bf16, and with a group of 8 query heads the running
output after every block too. The AWQ quantizer on the card: the CPU's
grid index for every scale group and its scales within 1e-5; a checkpoint
it wrote decodes the in-memory model's greedy tokens exactly."""

import numpy as np
import pytest
import torch

from autoawq_tpu_torch.core.packing import pack_port, pad_cols
from autoawq_tpu_torch.nn.modules import alibi_slopes
from autoawq_tpu_torch.ops import (_build, attention, fused_attn_step,
                                   fused_mlp, gemm, moe_gemm, paged_attn,
                                   sharded_mlp)

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
    (255, 2048, 2048, 32, False),
    # falcon-7b's qkv at g64: K 4544 = 71 groups, unpadded
    (1, 4544, 4672, 64, True)])
def test_w4a16_gemv(cuda, rng, m, k, n, gs, zp):
    w = lin(rng, k, n, gs, zp, cuda)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    before = _build.LAUNCHES["w4a16_gemv"]
    got = gemm.w4a16_gemv(x, *w)
    assert _build.LAUNCHES["w4a16_gemv"] == before + 1
    assert rel(got, gemm.awq_matmul_plain(x, *w)) <= 1e-2


@pytest.mark.parametrize("m,k,n,gs,zp", [
    (256, 64, 40, 32, True), (300, 256, 2500, 64, False),
    (768, 2048, 11264, 128, True), (256, 5632, 2048, 128, True),
    # Mistral's gate_up at M = 4096; K = 64 (one partial 64-deep step);
    # K = 2080 (K % 64 = 32, the last step half zeros) with g32; g64;
    # N = 2500 (a ragged last column tile); M = 257 (one row in the last
    # 128-row tile); N = 2502 (rows not 16-byte aligned: padded once to
    # 2504 columns as the port's loaders build it, core/packing.pad_cols)
    (4096, 4096, 28672, 128, True), (256, 64, 4096, 64, False),
    (512, 2080, 1024, 32, True), (384, 4096, 6144, 64, True),
    (300, 2048, 2500, 128, True), (257, 2048, 2048, 128, True),
    (256, 512, 2502, 32, True),
    (256, 4544, 4672, 64, True)])  # falcon-7b's qkv at g64, K unpadded
def test_w4a16_gemm(cuda, rng, m, k, n, gs, zp):
    w = pad_cols(*lin(rng, k, n, gs, zp, cuda))
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    before = _build.LAUNCHES["w4a16_gemm"]
    got = gemm.w4a16_gemm(x, *w)
    assert _build.LAUNCHES["w4a16_gemm"] == before + 1
    assert rel(got[:, :n], gemm.awq_matmul_plain(x, *w)[:, :n]) <= 1e-2


@pytest.mark.parametrize("m", [1, 7, 8, 9, 64, 255])
@pytest.mark.parametrize("k,n", [(2048, 2560), (4096, 6144)],
                         ids=["tinyllama_qkv", "mistral_qkv"])
def test_w4a16_gemv_rows_at_model_widths(cuda, rng, m, k, n):
    """K1's tensor-core GEMV at the row counts that change its plan (one n8
    tile, a partial one, several, row groups of 32 over warps, 255 rows)
    at TinyLlama's and Mistral's qkv widths: one launch, held against the
    twin."""
    w = lin(rng, k, n, 128, True, cuda)
    x = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    before = _build.LAUNCHES["w4a16_gemv"]
    got = gemm.w4a16_gemv(x, *w)
    assert _build.LAUNCHES["w4a16_gemv"] == before + 1
    assert rel(got, gemm.awq_matmul_plain(x, *w)) <= 1e-2


def test_w4a16_gemv_raises_on_what_it_does_not_take(cuda, rng):
    """K1 loads 16 bytes of weights a lane and walks K 32 deep: N % 4 != 0,
    an operand off a 16-byte base and groups of 16 raise ValueError."""
    x = torch.randn(1, 512, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        gemm.w4a16_gemv(x, *lin(rng, 512, 2502, 32, True, cuda))
    qw, sc, qz = lin(rng, 512, 2052, 32, True, cuda)
    off = torch.empty(qw.numel() + 1, dtype=qw.dtype, device=cuda)[1:]
    off = off.view(qw.shape).copy_(qw)  # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        gemm.w4a16_gemv(x, off, sc, qz)
    with pytest.raises(ValueError, match="multiple of 32"):
        gemm.w4a16_gemv(x, *lin(rng, 512, 2048, 16, True, cuda))


def test_w4a16_gemm_raises_on_a_ragged_raw_operand(cuda, rng):
    """K2 copies no weight: a raw operand of N = 2502 (rows off 16 bytes)
    or off a 16-byte base raises, where the wrapper once padded it."""
    x = torch.randn(256, 512, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 4"):
        gemm.w4a16_gemm(x, *lin(rng, 512, 2502, 32, True, cuda))
    qw, sc, qz = lin(rng, 512, 2052, 32, True, cuda)
    off = torch.empty(qw.numel() + 1, dtype=qw.dtype, device=cuda)[1:]
    off = off.view(qw.shape).copy_(qw)  # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        gemm.w4a16_gemm(x, off, sc, qz)


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
    (8, 2048, 5632, "silu"), (32, 2048, 5632, "gelu"),
    # Gemma-2-9B's MLP (gelu-tanh, h 3584, inter 14336) at decode
    (1, 3584, 14336, "gelu_pytorch_tanh"),
    (8, 3584, 14336, "gelu_pytorch_tanh")])
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
    (1, 150, 4, 2, 96), (1, 140, 4, 1, 256),
    # traffic D's prefill (Mistral-7B, 8 x 2048); S = 129 and 1000 (a
    # ragged last q and key tile); hd 96 (zero-padded to 128) and 256
    (8, 2048, 32, 8, 128), (2, 129, 32, 8, 128), (1, 1000, 8, 2, 128),
    (2, 1000, 8, 4, 96), (1, 1000, 4, 2, 256), (1, 64, 2, 1, 64),
    # GPT-J-6B's prefill (16 heads of 256, MHA) and Qwen3-8B's, 2 x 384
    (2, 384, 16, 16, 256), (2, 384, 32, 8, 128)])
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


@pytest.mark.parametrize("bm,t,gs,zp", [
    (8, 3, 64, False),     # the GEMV instance; blocks past max_live zeroed
    (16, 40, 64, True),    # the 16-row wgmma tile
    (24, 100, 32, False),  # 24 rows in a 32-row tile: 8 rows of the next
    (64, 300, 128, True),
    (96, 500, 64, False),  # 96 rows in a 128-row tile
    (128, 700, 128, True)])
def test_moe_gemm_instances_store_only_their_blocks(cuda, bm, t, gs, zp):
    """K6 called straight through its C entry with an output longer than
    its rows, prefilled: every block's rows equal the twin's (no block's
    tile writes into its neighbour's rows), the dead trailing blocks are
    zero, and no row past the last block changes, though an instance
    larger than bm reads rows past it."""
    gen = torch.Generator(device=cuda).manual_seed(bm)
    e, k, k_dim, n = 8, 2, 512, 384
    w = stack(gen, e, k_dim, n, gs, zp, cuda)
    topi = routed(gen, t, e, k, cuda)
    gather_idx, be, live, _ = moe_gemm.moe_align(topi, e, bm)
    x = (torch.randn(t, k_dim, device=cuda, generator=gen) * 0.5).to(
        torch.bfloat16)
    xs = torch.cat([x, x.new_zeros((1, k_dim))])[
        torch.clamp(gather_idx.long() // k, max=t)]
    nb, rows = be.numel(), be.numel() * bm
    tok = moe_gemm.tile_rows(bm)
    max_live = min(nb, t * k)
    csize = gemm.gemv_plan(bm, k_dim, n, max_live, 132)[2] if tok == 0 else 1
    out = torch.full((rows + 128, n), 7.0, dtype=torch.bfloat16,
                     device=cuda)
    _build.launch("moe_gemm", xs.data_ptr(), be.data_ptr(), live.data_ptr(),
                  w["qweight"].data_ptr(), w["scales"].data_ptr(),
                  _build.ptr(w["qzeros"]), out.data_ptr(), e, nb, bm, k_dim,
                  n, k_dim // gs, gs, max_live, csize, tok)
    torch.cuda.synchronize()
    ref = moe_gemm.grouped_awq_matmul_plain(
        xs, be, w["qweight"], w["scales"], w["qzeros"], block_m=bm,
        live_blocks=live)
    assert int(live) < nb  # the case has dead blocks
    assert rel(out[:rows], ref) <= 1e-2
    assert not out[int(live) * bm:rows].any()
    assert bool((out[rows:] == 7.0).all())


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
    with pytest.raises(ValueError):  # K6 needs groups of 32
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
    (1, 3584, 14336, "gelu_pytorch_tanh", (True, True, True)),  # Gemma-2
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


def paged_pool(gen, b, nh, nkv, hd, ps, n_pool, pps, lengths, dev,
               dtype=torch.bfloat16, int8=False):
    """Random pools [nkv, n_pool, ps, hd] and a table whose slots own
    distinct pages; a slot of length 1 keeps the trash page 0."""
    q = torch.randn(b, nh, hd, device=dev, generator=gen)
    k, v = (torch.randn(nkv, n_pool, ps, hd, device=dev, generator=gen)
            for _ in range(2))
    perm = torch.randperm(n_pool - 1, device=dev, generator=gen)[: b * pps]
    table = (perm + 1).reshape(b, pps).to(torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    table[lengths == 1] = 0
    if int8:
        from autoawq_tpu_torch.nn.modules import _kv_quantize
        (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
        return q, k, v, table, lengths, ks, vs
    return q, k.to(dtype), v.to(dtype), table, lengths, None, None


@pytest.mark.parametrize("case", [
    "bf16", "f32", "int8", "window", "softcap", "alibi", "tinyllama",
    "mha_odd_hd", "group16", "split_edges", "all_length_1",
    "window_cuts_a_split", "int8_softcap_alibi", "odd_hd_f32", "mpt_alibi",
    "gemma2_softcap"])
def test_paged_attn_k7(cuda, case):
    """K7 against its twin: Mistral's decode shape (B 8, 32/8 heads, hd 128,
    ps 64, 8 pages a slot, ragged lengths with 1 and 512 and a trash-page
    slot), then the int8 pool, a window, softcap, ALiBi, TinyLlama widths,
    MHA with hd 96 and ps 16, and a group of 16. Then the split design's
    edges (splits of one 64-row page): lengths 63, 64, 65, 4095 and 4096
    over 64-page tables, every slot of length 1, a window of 70 that starts
    inside a split, int8 with softcap and ALiBi across splits, and hd 36 on
    f32 pools (element loads, no 16-byte vectors). Then the zoo's widths:
    MPT-7B (32/32 heads, hd 128) with its own ALiBi slopes, and Gemma-2-9B
    (16/8 heads, hd 256) with its softcap 50 and window 4096."""
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = dict(b=8, nh=32, nkv=8, hd=128, ps=64, n_pool=80, pps=8,
                 lengths=[1, 512, 77, 128, 300, 1, 64, 65])
    if case == "tinyllama":
        shape.update(nh=32, nkv=4, hd=64)
    if case == "mha_odd_hd":
        shape.update(b=3, nh=4, nkv=4, hd=96, ps=16, n_pool=40, pps=8,
                     lengths=[1, 128, 45])
    if case == "group16":
        shape.update(b=2, nh=32, nkv=2, hd=64, lengths=[200, 3])
    if case == "split_edges":
        shape.update(b=5, n_pool=321, pps=64,
                     lengths=[63, 64, 65, 4095, 4096])
    if case == "all_length_1":
        shape.update(lengths=[1] * 8)
    if case == "odd_hd_f32":
        shape.update(b=3, nh=8, nkv=2, hd=36, ps=16, n_pool=40,
                     lengths=[1, 128, 45])
    if case == "mpt_alibi":
        shape.update(nh=32, nkv=32, hd=128)
    if case == "gemma2_softcap":
        shape.update(nh=16, nkv=8, hd=256)
    q, k, v, table, lengths, ks, vs = paged_pool(
        g, dev=cuda,
        dtype=torch.float32 if case in ("f32", "odd_hd_f32")
        else torch.bfloat16,
        int8=case in ("int8", "int8_softcap_alibi"), **shape)
    kw = dict(scale=shape["hd"] ** -0.5, k_scales=ks, v_scales=vs)
    if case == "window":
        kw["window"] = 100
    if case == "window_cuts_a_split":
        kw["window"] = 70  # slot 300 keeps rows 230-299: from inside a page
    if case in ("softcap", "int8_softcap_alibi"):
        kw["softcap"] = 30.0
    if case == "gemma2_softcap":
        kw.update(softcap=50.0, window=4096)
    if case == "mpt_alibi":
        kw["alibi_slopes"] = alibi_slopes(shape["nh"], cuda)
    if case in ("alibi", "int8_softcap_alibi"):
        kw["alibi_slopes"] = torch.rand(shape["nh"], device=cuda,
                                        generator=g) * 0.1
    before = _build.LAUNCHES["paged_attn"]
    got = paged_attn.paged_decode_attention(q, k, v, table, lengths, **kw)
    assert _build.LAUNCHES["paged_attn"] == before + 1
    ref = paged_attn.paged_decode_attention_plain(q, k, v, table, lengths,
                                                  **kw)
    assert got.dtype == torch.float32
    assert row_rel(got, ref, shape["hd"]) <= 1e-4


@pytest.mark.parametrize("nh,nkv,hd,ppcb,softcap,pps,lengths", [
    (32, 8, 128, 8, None, 8, None), (32, 8, 128, 4, 30.0, 8, None),
    (32, 4, 64, 8, None, 8, None), (32, 4, 64, 2, 30.0, 8, None),
    (32, 4, 64, 2, None, 16, [1, 1024, 77, 128, 300, 1, 64, 999]),
    (32, 8, 128, 8, None, 64, [63, 64, 65, 4095, 4096]),
    (32, 8, 128, 64, 30.0, 64, [4096, 1, 2000]),
    (32, 8, 128, 8, None, 8, [1] * 8)])
def test_paged_attn_stock_k9(cuda, nh, nkv, hd, ppcb, softcap, pps,
                             lengths):
    """K9 against its twin at Mistral's (group 4: f32 running output) and
    TinyLlama's widths (group 8: the running output in bf16); then group 8
    with 2-page blocks over a 16-page table (two splits a block), lengths
    at the splits' edges over 64-page tables (one block of 64 pages: 64
    splits merged into it), and every slot of length 1."""
    g = torch.Generator(device=cuda).manual_seed(4)
    lengths = lengths or [1, 512, 77, 128, 300, 1, 64, 65]
    b = len(lengths)
    q, k, v, table, lengths, _, _ = paged_pool(
        g, b, nh, nkv, hd, 64, b * pps + 1, pps, lengths, cuda)
    q = (q * hd ** -0.5).to(torch.bfloat16)
    before = _build.LAUNCHES["paged_attn_stock"]
    got = paged_attn.stock_paged_attention(
        q, k, v, lengths, table, pages_per_compute_block=ppcb,
        softcap=softcap)
    assert _build.LAUNCHES["paged_attn_stock"] == before + 1
    ref = paged_attn.stock_paged_attention_plain(
        q, k, v, lengths, table, pages_per_compute_block=ppcb,
        softcap=softcap)
    assert got.dtype == torch.bfloat16
    assert row_rel(got, ref, hd) <= 2 ** -6


def test_paged_attn_refusals(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, table, lengths, _, _ = paged_pool(g, 2, 8, 2, 64, 16, 8, 2,
                                               [3, 20], cuda)
    with pytest.raises(NotImplementedError):  # head dim 512
        paged_attn.paged_decode_attention(
            torch.zeros(2, 8, 512, device=cuda),
            torch.zeros(2, 8, 16, 512, device=cuda),
            torch.zeros(2, 8, 16, 512, device=cuda), table, lengths,
            scale=1.0)
    with pytest.raises(ValueError):  # int8 pages without scales
        paged_attn.paged_decode_attention(q, k.to(torch.int8),
                                          v.to(torch.int8), table, lengths,
                                          scale=1.0)
    with pytest.raises(ValueError):  # K9 takes bf16 only
        paged_attn.stock_paged_attention(
            q.bfloat16(), k.float(), v.float(), lengths, table,
            pages_per_compute_block=2)


def test_paged_attn_refuses_a_misaligned_pool(cuda):
    """K7 and K9 read pool rows as 16-byte vectors: a contiguous pool whose
    base sits one element past an alignment raises ValueError in both
    wrappers, and nothing is launched."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, table, lengths, _, _ = paged_pool(g, 2, 8, 2, 64, 16, 8, 2,
                                               [3, 20], cuda)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out
    ks, vs = shifted(k), shifted(v)
    assert ks.is_contiguous() and ks.data_ptr() % 16
    launches = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        paged_attn.paged_decode_attention(q, ks, vs, table, lengths,
                                          scale=1.0)
    with pytest.raises(ValueError, match="16-byte"):
        paged_attn.stock_paged_attention(q.bfloat16(), ks, vs, lengths,
                                         table, pages_per_compute_block=2)
    assert dict(_build.LAUNCHES) == launches


def tiny_llama(gen, dev):
    """A 2-layer fused llama (8/2 heads, hd 64) with random int4 weights on
    the card."""
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    cfg = ModelConfig(model_type="llama", vocab_size=256, hidden_size=512,
                      intermediate_size=1024, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=2,
                      head_dim=64)
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=2, fp_dtype=torch.bfloat16, device=dev))
    return cfg, params


@pytest.mark.parametrize("route", ["bespoke", "stock"])
def test_paged_and_slot_decode_steps_never_sync_the_host(cuda, route):
    """One paged decode step (K7 or K9 with K1 and K3 around it) and one
    slot-pool decode step (per-slot positions: index-tensor cache writes,
    no K5) never wait for the card under
    ``torch.cuda.set_sync_debug_mode("error")``; the inputs are on the card
    already, as a captured step would hold them."""
    from autoawq_tpu_torch.serve import batching, paged
    from autoawq_tpu_torch.serve import generate as gen

    g = torch.Generator(device=cuda).manual_seed(6)
    cfg, params = tiny_llama(g, cuda)
    b = 8
    eng = paged.PagedBatchingEngine(cfg, params, max_batch=b, page_size=16,
                                    total_pages=80, pages_per_seq=8,
                                    paged_attn=route)
    for i in range(b):
        eng.add_request(i, torch.randint(0, 256, (20 + 7 * i,),
                                         generator=torch.Generator()
                                         .manual_seed(i)).numpy(),
                        max_new_tokens=30)
    eng.step()  # admits every slot and builds the kernels
    tokens = eng._h2d(eng.last_token[:, None])
    table, pos = eng._h2d(eng.table), eng._h2d(eng.pos)
    caches = gen.init_kv_cache(cfg, b, 64, device=cuda)
    spos = torch.arange(b, device=cuda) * 3 + 5
    batching.batched_decode_step(cfg, params, tokens, caches, spos)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = paged.paged_decode_step(cfg, params, tokens, eng.pages,
                                            table, pos, paged_attn=route)
        slot_logits, _ = batching.batched_decode_step(cfg, params, tokens,
                                                      caches, spos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    name = "paged_attn" if route == "bespoke" else "paged_attn_stock"
    assert _build.LAUNCHES[name] == 2
    assert _build.LAUNCHES["fused_attn_step"] == 0
    assert _build.LAUNCHES["fused_mlp"] == 4
    assert bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(slot_logits).all())


# ---- K3, K8 and K5 on the tensor-core GEMV core (two launches for K3 and
# K8, four for K5, no split-K workspace)

MISTRAL_MLP = (4096, 14336)  # hidden, intermediate
QUANTS = {"g32": (32, True), "g64": (64, True), "g128 symmetric": (128, False)}


def card_lin(gen, k, n, gs, zp):
    """A random int4 linear drawn on the card (Mistral widths would take
    seconds to pack on the host)."""
    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int64,
                             device=gen.device, generator=gen).to(torch.int32)
    g = k // gs
    return (words(k // 8, n),
            (torch.rand(g, n, device=gen.device, generator=gen) + 0.5) * 0.01,
            words(-(-g // 8), n) if zp else None)


def cuda_kernels(fn):
    """The CUDA kernels (memory copies and sets aside) that one call of
    ``fn`` launches, counted by torch.profiler after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith(("Memcpy", "Memset")))


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("m", [1, 8, 9, 32])
@pytest.mark.parametrize("kernel", ["fused_mlp", "fused_mlp3"])
def test_decode_mlp_at_mistral_widths(cuda, kernel, m, quant):
    """K3 and K8 at Mistral's MLP widths, at the row counts that change the
    core's plan (one n8 tile, a partial second, 32 rows over 128-column
    CTAs), with groups of 32 and 64 and without zero points: one counted
    launch, held against the twin at K3's 2e-2."""
    gs, zp = QUANTS[quant]
    h, inter = MISTRAL_MLP
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m)
    x = (torch.randn(m, h, device=cuda, generator=gen) * 0.5).to(
        torch.bfloat16)
    dn = card_lin(gen, inter, h, gs, zp)
    if kernel == "fused_mlp":
        gu = card_lin(gen, h, 2 * inter, gs, zp)
        args = (x, gu[0], gu[1], dn[0], dn[1], gu[2], dn[2])
        fn, plain = fused_mlp.fused_mlp, fused_mlp.fused_mlp_plain
    else:
        g, u = card_lin(gen, h, inter, gs, zp), card_lin(gen, h, inter, gs, zp)
        args = (x, g[0], g[1], u[0], u[1], dn[0], dn[1], g[2], u[2], dn[2])
        fn, plain = sharded_mlp.fused_mlp3, sharded_mlp.fused_mlp3_plain
    before = _build.LAUNCHES[kernel]
    got = fn(*args, inter=inter)
    assert _build.LAUNCHES[kernel] == before + 1
    assert rel(got, plain(*args, inter=inter)) <= 2e-2


@pytest.mark.parametrize("kernel", ["fused_mlp", "fused_mlp3"])
def test_decode_mlp_takes_two_cuda_launches(cuda, rng, kernel):
    h, inter = 2048, 5632
    x = (torch.randn(8, h, device=cuda) * 0.5).to(torch.bfloat16)
    dn = lin(rng, inter, h, 128, True, cuda)
    if kernel == "fused_mlp":
        gu = lin(rng, h, 2 * inter, 128, True, cuda)
        n = cuda_kernels(lambda: fused_mlp.fused_mlp(
            x, gu[0], gu[1], dn[0], dn[1], gu[2], dn[2], inter=inter))
    else:
        g, u = lin(rng, h, inter, 128, True, cuda), lin(rng, h, inter, 128,
                                                        True, cuda)
        n = cuda_kernels(lambda: sharded_mlp.fused_mlp3(
            x, g[0], g[1], u[0], u[1], dn[0], dn[1], g[2], u[2], dn[2],
            inter=inter))
    assert n == 2


def test_decode_mlp_raises_on_groups_the_core_does_not_take(cuda, rng):
    """Groups of 16 rows (a multiple of 8, which the CUDA-core passes
    took), and K8's gate and up of different group sizes, raise."""
    x = torch.randn(2, 256, device=cuda).to(torch.bfloat16)
    gu16 = lin(rng, 256, 1024, 16, True, cuda)
    dn = lin(rng, 512, 256, 64, True, cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_mlp.fused_mlp(x, gu16[0], gu16[1], dn[0], dn[1], gu16[2],
                            dn[2], inter=512)
    g16, g64 = lin(rng, 256, 512, 16, True, cuda), lin(rng, 256, 512, 64,
                                                       True, cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        sharded_mlp.fused_mlp3(x, g16[0], g16[1], g16[0], g16[1], dn[0],
                               dn[1], g16[2], g16[2], dn[2], inter=512)
    g32 = lin(rng, 256, 512, 32, True, cuda)
    with pytest.raises(ValueError, match="differ"):
        sharded_mlp.fused_mlp3(x, g32[0], g32[1], g64[0], g64[1], dn[0],
                               dn[1], g32[2], g64[2], dn[2], inter=512)


@pytest.mark.parametrize("b,nh,nkv,hd,h,t,vl,window,int8,bias", [
    (8, 16, 4, 64, 1024, 1024, 700, 100, False, False),   # window cuts a split
    (4, 8, 4, 256, 2048, 300, 299, None, False, False),   # hd 256
    (4, 8, 4, 256, 2048, 300, 200, 64, True, True),       # hd 256, int8
    (8, 32, 8, 128, 4096, 2112, 1000, 129, True, False),  # int8, window
    (3, 32, 8, 128, 4096, 64, 0, None, True, True),       # vl 0, int8, bias
    (2, 8, 2, 128, 1024, 4096, 4096, None, False, False),  # whole cache
    (1, 4, 4, 64, 512, 200, 150, 1, False, False),        # window 1: diagonal
    (2, 8, 4, 64, 512, 128, -3, None, False, False),      # vl < 0: no rows
])
def test_fused_attn_step_split_edges(cuda, rng, b, nh, nkv, hd, h, t, vl,
                                     window, int8, bias):
    """K5's attention on K7's split kernel over the contiguous cache: a
    window whose first row falls inside a split, head dims 64 / 128 / 256,
    int8 caches, vl = 0 and a full cache, a window of one row (the diagonal
    term alone), a negative length (no cached rows, as in the twin), with
    and without a qkv bias: held against the twin at K5's limits."""
    x, qkv, o, kc, vc, cos, sin, sc = k5_inputs(rng, cuda, b, nh, nkv, hd, h,
                                                t, int8, bias)
    kw = dict(nh=nh, nkv=nkv, hd=hd, scale=hd ** -0.5, window=window, **sc)
    y, k, v = fused_attn_step.fused_attention_step(x, qkv, o, kc, vc, cos,
                                                   sin, vl, **kw)
    ry, rk, rv = fused_attn_step.fused_attention_step_plain(
        x, qkv, o, kc, vc, cos, sin, vl, **kw)
    assert row_rel(y, ry, h) <= 2 ** -6
    assert row_rel(k, rk, hd) <= 2 ** -7 and row_rel(v, rv, hd) <= 2 ** -7


def test_fused_attn_step_reads_the_length_from_the_card(cuda, rng):
    """A captured step replays at any position: with the valid length a
    device int32, one graph replayed after the length changes on the card
    gives the new length's result; a host int gives the same result."""
    b, nh, nkv, hd, h, t = 8, 32, 8, 128, 4096, 512
    x, qkv, o, kc, vc, cos, sin, _ = k5_inputs(rng, cuda, b, nh, nkv, hd, h,
                                               t, False)
    kw = dict(nh=nh, nkv=nkv, hd=hd, scale=hd ** -0.5)
    vl = torch.full((1,), 100, dtype=torch.int32, device=cuda)
    step = fused_attn_step.fused_attention_step
    ref = step(x, qkv, o, kc, vc, cos, sin, 100, **kw)[0]
    assert torch.equal(step(x, qkv, o, kc, vc, cos, sin, vl, **kw)[0], ref)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(x, qkv, o, kc, vc, cos, sin, vl, **kw)[0]
    vl.fill_(400)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, step(x, qkv, o, kc, vc, cos, sin, 400, **kw)[0])


def test_fused_attn_step_takes_four_cuda_launches(cuda, rng):
    x, qkv, o, kc, vc, cos, sin, sc = k5_inputs(rng, cuda, 8, 32, 8, 128,
                                                4096, 2112, True, True)
    kw = dict(nh=32, nkv=8, hd=128, scale=128 ** -0.5, **sc)
    assert cuda_kernels(lambda: fused_attn_step.fused_attention_step(
        x, qkv, o, kc, vc, cos, sin, 2000, **kw)) == 4


def test_fused_attn_step_raises_on_groups_the_core_does_not_take(cuda, rng):
    x, _, o, kc, vc, cos, sin, _ = k5_inputs(rng, cuda, 2, 4, 2, 64, 256, 64,
                                             False)
    qkv16 = dict(zip(("qweight", "scales", "qzeros"),
                     lin(rng, 256, 8 * 64, 16, True, cuda)))
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_attn_step.fused_attention_step(x, qkv16, o, kc, vc, cos, sin, 3,
                                             nh=4, nkv=2, hd=64, scale=0.125)


def test_bs8_decode_at_head_dim_320_takes_the_plain_attention(cuda):
    """hd 320 is above K5's ``HEAD_DIM_MAX``: a bf16 decode at B = 8 (which
    K5's rule would take) runs K1 and the plain attention, launches no K5,
    and its logits sit within twice the bf16 twin's distance from f32
    (+1e-3) of the f32 plain path, the limit of ``chip_smoke.py``'s
    teacher-forced rows."""
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    cfg = ModelConfig(model_type="llama", vocab_size=256, hidden_size=1280,
                      intermediate_size=512, num_hidden_layers=1,
                      num_attention_heads=4, num_key_value_heads=2,
                      head_dim=320)
    params = fuse_model(cfg, random_quantized_params(
        cfg, seed=0, fp_dtype=torch.bfloat16, device=cuda))
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (8, 16))).to(cuda)
    runs = {"kernel": ("auto", torch.bfloat16),
            "plain": ("plain", torch.bfloat16),
            "f32": ("plain", torch.float32)}
    logits, launches, token = {}, {}, None
    for name, (method, dt) in runs.items():  # the kernel path first
        caches = gen.init_kv_cache(cfg, 8, 64, dt, cuda)
        first, _ = gen.prefill(cfg, params, prompt, caches, method, dt)
        if token is None:
            token = first.argmax(-1)[:, None]
        _build.reset_launches()
        logits[name], _ = gen.decode_step(cfg, params, token, caches, 16,
                                          method, dt)
        torch.cuda.synchronize()
        launches[name] = dict(_build.LAUNCHES)
    assert launches["kernel"]["fused_attn_step"] == 0
    assert launches["kernel"]["w4a16_gemv"] == 2  # qkv and o
    assert bool(torch.isfinite(logits["kernel"]).all())
    limit = 2 * rel(logits["plain"], logits["f32"]) + 1e-3
    assert rel(logits["kernel"], logits["f32"]) <= limit


def _pool_from_cache(cache, ps):
    """A contiguous cache [B, nkv, T, hd] copied into a page pool
    [nkv, 1 + B * T / ps, ps, hd] (page 0 the trash page) and its table."""
    b, nkv, t, hd = cache["k"].shape
    n = t // ps
    table = torch.arange(1, 1 + b * n, device=cache["k"].device,
                         dtype=torch.int32).reshape(b, n)
    pool = {}
    for name in ("k", "v"):
        pages = cache[name].new_zeros((nkv, 1 + b * n, ps, hd))
        pages[:, 1:] = cache[name].reshape(b, nkv, n, ps, hd).transpose(
            0, 1).reshape(nkv, b * n, ps, hd)
        pool[name + "_pages"] = pages
    return pool, table


def test_prompt_and_paged_step_at_head_dim_320_take_the_plain_routes(cuda):
    """hd 320 is above K4's and K7's widest instance (256): a 128-token
    prompt takes ``_attend`` (no K4) and a paged step on the default
    "bespoke" route takes the gather (no K7). The prompt's last logits and
    the paged step's sit within twice the bf16 plain path's distance from
    the f32 plain path on the CPU (+1e-3), the teacher-forced rule."""
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve.paged import paged_decode_step
    from autoawq_tpu_torch.utils.synth import random_quantized_params
    from autoawq_tpu_torch.utils.tree import to_device

    cfg = ModelConfig(model_type="llama", vocab_size=256, hidden_size=1280,
                      intermediate_size=512, num_hidden_layers=1,
                      num_attention_heads=4, num_key_value_heads=2,
                      head_dim=320)
    params = random_quantized_params(cfg, seed=0, fp_dtype=torch.bfloat16,
                                     device=cuda)
    cpu = torch.device("cpu")
    host = to_device(params, cpu)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 128)))
    runs = {"kernel": (cuda, "auto", torch.bfloat16),
            "plain": (cpu, "plain", torch.bfloat16),
            "f32": (cpu, "plain", torch.float32)}
    first, step, launches, token = {}, {}, {}, None
    for name, (dev, method, dt) in runs.items():  # the card first
        p = params if dev == cuda else host
        caches = gen.init_kv_cache(cfg, 2, 192, dt, dev)
        _build.reset_launches()
        first[name], _ = gen.prefill(cfg, p, prompt.to(dev), caches, method,
                                     dt)
        if token is None:
            token = first[name].argmax(-1)[:, None].cpu()
        pool, table = _pool_from_cache(caches[0], 64)
        pos = torch.full((2,), 128, dtype=torch.int32, device=dev)
        step[name], _ = paged_decode_step(cfg, p, token.to(dev), [pool],
                                          table, pos, method, dt)
        if dev == cuda:
            torch.cuda.synchronize()
        launches[name] = dict(_build.LAUNCHES)
    assert launches["kernel"]["prefill_attention"] == 0
    assert launches["kernel"]["paged_attn"] == 0
    assert launches["kernel"]["w4a16_gemm"] > 0  # the prompt's linears
    for got in (first, step):
        assert bool(torch.isfinite(got["kernel"]).all())
        limit = 2 * rel(got["plain"], got["f32"]) + 1e-3
        assert rel(got["kernel"].cpu(), got["f32"]) <= limit


QUANT_TINY = dict(model_type="llama", vocab_size=256, hidden_size=128,
                  intermediate_size=256, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=4, head_dim=32,
                  max_position_embeddings=64)


def outlier_tiny(device):
    from autoawq_tpu_torch.io.hf import init_random_params
    from autoawq_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(**QUANT_TINY)
    params = init_random_params(cfg, seed=0, device=device)
    params["embed_tokens"]["weight"][:, :6] *= 8.0
    return cfg, params


def test_quantizer_on_the_card_chooses_as_on_the_cpu(cuda):
    """The AWQ searches on the card (the default device) pick the CPU's
    grid index for every scale group, and scales within 1e-5 of theirs."""
    from autoawq_tpu_torch.config import AwqConfig
    from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer

    calib = np.random.default_rng(42).integers(0, 256, (4, 32))
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", None)):
        cfg, params = outlier_tiny(dev or cuda)
        q = AwqQuantizer(cfg, AwqConfig(q_group_size=32), params, calib,
                         progress=False, device=dev)
        q.quantize()
        assert q.device.type == name.replace("card", "cuda")
        runs[name] = q
    best = {k: [[c["best"] for c in layer] for layer in q.scale_choices]
            for k, q in runs.items()}
    assert best["card"] == best["cpu"]
    for (_, a), (_, b) in zip(
            (x for layer in runs["cpu"].all_scales for x in layer),
            (x for layer in runs["card"].all_scales for x in layer)):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


def test_card_quantized_checkpoint_decodes_as_the_quantized_model(
        cuda, tmp_path):
    """Quantized on the card, saved, reloaded fused: the greedy tokens of
    the in-memory model with its floats rounded to fp16 (what the
    checkpoint holds), through the same kernels."""
    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.api import cast_params
    from autoawq_tpu_torch.nn.fuse import fuse_model
    from autoawq_tpu_torch.serve import generate as gen

    cfg, params = outlier_tiny(cuda)
    model = AwqCausalLM(cfg, params)
    model.quantize(calib_data=np.random.default_rng(1).integers(
        0, 256, (4, 32)), quant_config={"q_group_size": 32}, progress=False)
    assert model.params["layers"][0]["mlp"]["up_proj"]["qweight"].is_cuda
    model.save_quantized(str(tmp_path))
    loaded = AwqCausalLM.from_quantized(str(tmp_path), fuse_layers=True)
    mem = cast_params(_map_floats(model.params, lambda t: t.half().float()),
                      torch.bfloat16)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 16))).to(cuda)
    before = dict(_build.LAUNCHES)
    got = loaded.generate(prompt, max_new_tokens=12)
    assert _build.LAUNCHES["w4a16_gemv"] > before["w4a16_gemv"]
    ref = gen.generate(cfg, fuse_model(cfg, mem), prompt, 12)
    assert torch.equal(got, ref)


def _map_floats(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_floats(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_floats(v, fn) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


# ---- MLA and DeepSeek / Qwen3 MoE at published widths

@pytest.mark.parametrize("t,e,k,k_dim,n,gs", [
    (1, 64, 6, 2048, 2816, 64),     # DeepSeek-V2-Lite decode, gate_up
    (768, 64, 6, 1408, 2048, 64),   # V2-Lite's prefill 2 x 384, down (bm 16)
    (1, 128, 8, 2048, 1536, 128),   # Qwen3-30B-A3B decode, gate_up
    (768, 128, 8, 768, 2048, 128),  # Qwen3-30B-A3B prefill, down
])
def test_moe_gemm_at_published_expert_counts(cuda, t, e, k, k_dim, n, gs):
    """K6 against its twin at 64 experts top-6 and 128 top-8: one launch,
    1e-2 of max |twin|, the trailing dead blocks zero."""
    gen = torch.Generator(device=cuda).manual_seed(t + e)
    w = stack(gen, e, k_dim, n, gs, True, cuda)
    topi = routed(gen, t, e, k, cuda)
    bm = moe_gemm.pick_block_m(t * k, e)
    gather_idx, block_expert, live, _ = moe_gemm.moe_align(topi, e, bm)
    x = (torch.randn(t, k_dim, device=cuda, generator=gen) * 0.5).to(
        torch.bfloat16)
    xs = torch.cat([x, x.new_zeros((1, k_dim))])[
        torch.clamp(gather_idx.long() // k, max=t)]
    args = (xs, block_expert, w["qweight"], w["scales"], w["qzeros"])
    before = _build.LAUNCHES["moe_gemm"]
    got = moe_gemm.grouped_awq_matmul(*args, block_m=bm, live_blocks=live,
                                      max_live=t * k)
    assert _build.LAUNCHES["moe_gemm"] == before + 1
    ref = moe_gemm.grouped_awq_matmul_plain(*args, block_m=bm,
                                            live_blocks=live)
    assert rel(got, ref) <= 1e-2
    assert not got[int(live) * bm:].any()


def v2_lite_layer(gen, dev):
    """One DeepSeek-V2-Lite MoE layer at published width (MLA with lite q,
    64 experts top-6 stacked, 2 shared experts unfused) at g64, random int4
    weights on the card, and its 1-layer config."""
    from autoawq_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(model_type="deepseek_v2", vocab_size=256,
                      hidden_size=2048, intermediate_size=10944,
                      moe_intermediate_size=1408, num_hidden_layers=1,
                      num_attention_heads=16, num_key_value_heads=16,
                      num_experts=64, n_shared_experts=2,
                      num_experts_per_tok=6, kv_lora_rank=512,
                      qk_rope_head_dim=64, qk_nope_head_dim=128,
                      v_head_dim=128, rms_norm_eps=1e-6)
    bf = torch.bfloat16

    def qlin(k, n):
        return dict(zip(("qweight", "scales", "qzeros"),
                        card_lin(gen, k, n, 64, True)))

    def ones(n=2048):
        return {"weight": torch.ones(n, dtype=bf, device=dev)}
    layer = {
        "input_layernorm": ones(), "post_attention_layernorm": ones(),
        "self_attn": {"q_proj": qlin(2048, 16 * 192),
                      "kv_a_proj_with_mqa": qlin(2048, 576),
                      "kv_a_layernorm": ones(512),
                      "kv_b_proj": qlin(512, 16 * 256),
                      "o_proj": qlin(16 * 128, 2048)},
        "mlp": {"gate": {"kernel": (torch.randn(2048, 64, device=dev,
                                                generator=gen) * 0.02).to(bf)},
                "experts_stacked": {
                    "gate_up_proj": stack(gen, 64, 2048, 2816, 64, True, dev),
                    "down_proj": stack(gen, 64, 1408, 2048, 64, True, dev)},
                "shared_experts": {"gate_proj": qlin(2048, 2816),
                                   "up_proj": qlin(2048, 2816),
                                   "down_proj": qlin(2816, 2048)}}}
    return cfg, layer


def _block_step(cfg, layer, x, cache, pos, method, topi_tape=None):
    """One layer's decode step (latent cache, int ``pos``); with
    ``topi_tape`` the router's choice is recorded (an empty list) or
    replayed (a filled one)."""
    from autoawq_tpu_torch.nn import modules

    pos_t = torch.full((1, x.shape[1]), pos, device=x.device)
    cos, sin = modules.rope_tables(cfg, pos_t)
    t = cache["c"].shape[2]
    mask = torch.where(torch.arange(t, device=x.device) <= pos, 0.0,
                       -1e30).float()[None, None, None]
    route = modules.moe_route

    def taped(cfg_, p, xt, method="auto", topi=None):
        if topi_tape:
            return route(cfg_, p, xt, method, topi_tape[0])
        out = route(cfg_, p, xt, method, topi)
        topi_tape.append(out[1])
        return out
    if topi_tape is not None:
        modules.moe_route = taped
    try:
        return modules.block(cfg, layer, x, cos, sin, mask,
                             {**cache, "pos": pos}, method)[0]
    finally:
        modules.moe_route = route


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_v2_lite_layer_latent_decode_step_matches_plain(cuda, kv_quant):
    """One V2-Lite layer's bs1 decode step over a latent cache of 64 rows
    (absorbed MLA decode around K1; router, K6 x 2 and K8 for the shared
    experts) against the plain path on the same cache and the same expert
    choice: within 2e-2 of the output's scale (bf16 products in other
    orders, as ``moe_mlp``'s limit), and the step's launches exact."""
    from autoawq_tpu_torch.serve import generate as gen

    g = torch.Generator(device=cuda).manual_seed(12)
    cfg, layer = v2_lite_layer(g, cuda)
    cache = gen.init_kv_cache(cfg, 1, 80, device=cuda, kv_quant=kv_quant)[0]
    rows = torch.randn(1, 1, 64, 576, device=cuda, generator=g)
    if kv_quant:
        from autoawq_tpu_torch.nn.modules import _latent_row
        r, s = _latent_row(rows[..., :512], rows[..., 512:], True)
        cache["c"][:, :, :64], cache["c_s"][:, :, :64] = r, s
    else:
        cache["c"][:, :, :64] = rows.to(torch.bfloat16)
    x = torch.randn(1, 1, 2048, device=cuda, generator=g).to(torch.bfloat16)
    tape = []
    ref = _block_step(cfg, layer, x, {k: v.clone() for k, v in
                                      cache.items()}, 64, "plain", tape)
    _build.reset_launches()
    got = _block_step(cfg, layer, x, cache, 64, "auto", tape)
    assert rel(got, ref) <= 2e-2
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launches == {"w4a16_gemv": 3, "moe_gemm": 2, "fused_mlp3": 1}


def test_v2_lite_moe_layer_prefill_launches(cuda):
    """The same layer's prefill of 384 tokens into the latent cache: K2 for
    q_proj, kv_a, kv_b and o and the three shared-expert linears, K6
    twice, no K1, K4 or K8 (MLA prefill attends in plain ops)."""
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.serve import generate as gen

    g = torch.Generator(device=cuda).manual_seed(13)
    cfg, layer = v2_lite_layer(g, cuda)
    cache = gen.init_kv_cache(cfg, 1, 400, device=cuda)[0]
    x = torch.randn(1, 384, 2048, device=cuda, generator=g).to(
        torch.bfloat16)
    pos = torch.arange(384, device=cuda)[None]
    cos, sin = modules.rope_tables(cfg, pos)
    mask = modules.causal_mask(384, device=cuda)
    _build.reset_launches()
    y, _ = modules.block(cfg, layer, x, cos, sin, mask,
                         {**cache, "pos": 0}, causal_prefill=True)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    assert launches == {"w4a16_gemm": 7, "moe_gemm": 2}
    assert bool(torch.isfinite(y).all())
    assert cache["c"][:, :, :384].abs().sum() > 0


def test_card_quantized_mla_model_serves_as_its_reload(cuda, tmp_path):
    """A tiny DeepSeek-V2-Lite-shaped MLA + MoE model quantized on the card
    and served as ``quantize()`` left it (cast to bf16, nothing attached
    again): kv_b's dense f32 weight that ``quantize()`` attached holds
    its own nibbles' dequantization, so the model serves bit for bit as
    the same tree without the leaf (kv_b dequantized on every call, JAX's
    route) and, through the same kernels, as its reload: prefill logits
    within 2e-2 of the logit scale (the checkpoint rounds the scales and
    float weights to fp16) and equal greedy tokens."""
    from autoawq_tpu_torch import AwqCausalLM
    from autoawq_tpu_torch.api import cast_params
    from autoawq_tpu_torch.io.hf import init_random_params
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.ops.gemm import dequantize
    from autoawq_tpu_torch.serve import generate as gen

    cfg = ModelConfig.from_hf_dict(dict(
        model_type="deepseek_v2", vocab_size=256, hidden_size=64,
        intermediate_size=128, moe_intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        n_routed_experts=4, n_shared_experts=0, num_experts_per_tok=2,
        first_k_dense_replace=0, q_lora_rank=None, kv_lora_rank=32,
        qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
        topk_method="greedy", max_position_embeddings=64))
    params = init_random_params(cfg, seed=0, device=cuda)
    params["embed_tokens"]["weight"][:, :6] *= 8.0
    model = AwqCausalLM(cfg, params)
    model.quantize(calib_data=np.random.default_rng(1).integers(
        0, 256, (4, 32)), quant_config={"q_group_size": 32}, progress=False)
    model.save_quantized(str(tmp_path))
    loaded = AwqCausalLM.from_quantized(str(tmp_path))
    mem = cast_params(model.params, torch.bfloat16)
    n = cfg.num_attention_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    bare = dict(mem, layers=[])
    for lp in mem["layers"]:
        kv_b = lp["self_attn"]["kv_b_proj"]
        assert kv_b["dense"].dtype == torch.float32
        assert torch.equal(kv_b["dense"], dequantize(
            kv_b["qweight"], kv_b["scales"], kv_b.get("qzeros"))[:, :n])
        bare["layers"].append(dict(lp, self_attn=dict(
            lp["self_attn"], kv_b_proj={
                k: v for k, v in kv_b.items() if k != "dense"})))
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 16))).to(cuda)
    logits = []
    for p in (mem, bare, loaded.params):
        caches = gen.init_kv_cache(cfg, 1, 32, device=cuda)
        logits.append(gen.prefill(cfg, p, prompt, caches)[0])
    assert torch.equal(logits[0], logits[1])
    scale = float(logits[2].abs().max())
    assert float((logits[0] - logits[2]).abs().max()) <= 2e-2 * scale
    before = dict(_build.LAUNCHES)
    got = gen.generate(cfg, mem, prompt, 8)
    assert _build.LAUNCHES["w4a16_gemv"] > before["w4a16_gemv"]
    assert torch.equal(got, gen.generate(cfg, bare, prompt, 8))
    assert torch.equal(got, loaded.generate(prompt, max_new_tokens=8))


# --------------------------------------------------------------- training
# K10 / K11 (K4's backward) and the W4A16 Function's backward against the
# twins' autograd gradients, each gradient tensor at 2e-2 of its max |twin|
# (both round P and dS, or the twin's probabilities and cast gradients, to
# bf16 and sum in f32 in other orders); dx at 1e-2 (a bf16 product on the
# same bf16-rounded weights).

@pytest.mark.parametrize("b,s,nh,nkv,hd,strided", [
    (4, 512, 32, 8, 128, False),  # traffic W's step
    (2, 384, 32, 4, 64, False), (2, 384, 16, 16, 256, False),
    (2, 300, 32, 8, 128, True), (1, 512, 32, 8, 128, False),
    (1, 200, 8, 2, 96, True), (1, 64, 2, 1, 64, False),
    # tiles cut at every edge (one row past a 64-row tile, one short, one
    # past two; the 128-row K11 tile half live), GQA groups of 1, 2 and 8
    (2, 65, 8, 8, 128, False), (1, 127, 8, 4, 64, True),
    (2, 129, 16, 8, 128, True), (1, 1000, 32, 4, 128, False),
    (1, 2048, 32, 8, 128, False),  # B = 1, long: 32 key tiles, 16 pairs
    (2, 384, 16, 4, 256, False), (1, 129, 8, 2, 256, True)])  # hd 256, GQA
def test_prefill_attention_backward(cuda, b, s, nh, nkv, hd, strided):
    q = torch.randn(b, s, nh, hd, device=cuda).to(torch.bfloat16)
    kv = torch.randn(b, s, 2 * nkv, hd, device=cuda).to(torch.bfloat16)
    if not strided:
        kv = kv.contiguous()
    q.requires_grad_()
    kv.requires_grad_()
    dout = torch.randn(b, s, nh * hd, device=cuda).to(torch.bfloat16)
    scale = hd ** -0.5
    names = ("prefill_attention", "prefill_attention_dkv",
             "prefill_attention_dq")
    before = {n: _build.LAUNCHES[n] for n in names}
    out = attention.prefill_attention(q, kv[:, :, :nkv], kv[:, :, nkv:],
                                      scale)
    got = torch.autograd.grad(out, (q, kv), dout)
    assert all(_build.LAUNCHES[n] == before[n] + 1 for n in names)
    ref = attention.prefill_attention_plain(q, kv[:, :, :nkv],
                                            kv[:, :, nkv:], scale)
    want = torch.autograd.grad(ref, (q, kv), dout)
    assert row_rel(out, ref, hd) <= 2 ** -6
    assert rel(got[0], want[0]) <= 2e-2
    for half in (slice(0, nkv), slice(nkv, 2 * nkv)):  # dk, dv
        assert rel(got[1][:, :, half], want[1][:, :, half]) <= 2e-2


@pytest.mark.parametrize("b,s,nh,nkv,hd", [
    (4, 512, 32, 8, 128), (1, 129, 8, 2, 64), (2, 384, 16, 4, 256)])
def test_prefill_attention_backward_repeats_bits(cuda, b, s, nh, nkv, hd):
    # no atomics on the outputs: two calls on the same inputs, equal bits
    q = torch.randn(b, s, nh, hd, device=cuda).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=cuda).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=cuda).to(torch.bfloat16)
    dout = torch.randn(b, s, nh * hd, device=cuda).to(torch.bfloat16)
    scale = hd ** -0.5
    out, lse = attention.prefill_attention_lse(q, k, v, scale)
    first = attention.prefill_attention_bwd(q, k, v, out, lse, dout, scale)
    second = attention.prefill_attention_bwd(q, k, v, out, lse, dout, scale)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("b,s,nh,nkv,hd", [
    (2, 384, 32, 4, 64), (1, 300, 8, 2, 96), (2, 256, 16, 16, 256)])
def test_prefill_attention_lse_keeps_out(cuda, b, s, nh, nkv, hd):
    q = torch.randn(b, s, nh, hd, device=cuda).to(torch.bfloat16)
    k = torch.randn(b, s, nkv, hd, device=cuda).to(torch.bfloat16)
    v = torch.randn(b, s, nkv, hd, device=cuda).to(torch.bfloat16)
    scale = hd ** -0.5
    out, lse = attention.prefill_attention_lse(q, k, v, scale)
    assert torch.equal(out, attention.prefill_attention(q, k, v, scale))
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.repeat_interleave(
        nh // nkv, 2).float()) * scale
    keep = torch.ones(s, s, dtype=torch.bool, device=cuda).tril()
    want = torch.logsumexp(scores.masked_fill(~keep, float("-inf")), -1)
    assert (lse - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("m,k,n,gs,zp,out_features", [
    (300, 2048, 2560, 128, True, 2560), (512, 512, 1000, 64, False, 997),
    (16, 2048, 2048, 128, True, 2048)])
def test_awq_matmul_backward(cuda, rng, m, k, n, gs, zp, out_features):
    w = lin(rng, k, n, gs, zp, cuda)
    x = (torch.randn(m, k, device=cuda) * 0.5).to(torch.bfloat16)
    g = torch.randn(m, out_features, device=cuda).to(torch.bfloat16)
    kernel = "w4a16_gemm" if m >= gemm.WS_MIN_M else "w4a16_gemv"
    before = _build.LAUNCHES[kernel]
    xg = x.clone().requires_grad_()
    y = gemm.awq_matmul(xg, *w, out_features=out_features)
    (dx,) = torch.autograd.grad(y, xg, g)
    assert _build.LAUNCHES[kernel] == before + 1
    xp = x.clone().requires_grad_()
    ref = gemm.awq_matmul(xp, *w, out_features=out_features, method="plain")
    (want,) = torch.autograd.grad(ref, xp, g)
    assert y.shape == ref.shape and dx.shape == x.shape
    assert rel(y, ref) <= 1e-2
    assert rel(dx, want) <= 1e-2


def test_inference_launches_unchanged_without_grad(cuda):
    """Grad enabled, but nothing requires grad: the forward takes the
    inference kernels with the same launches and bits as under
    ``inference_mode``, and no backward kernel runs; a LoRA step on the
    same model launches K2 7 times a layer, K4 / K10 / K11 once."""
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.train import lora
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    cfg = ModelConfig(model_type="llama", vocab_size=512, hidden_size=512,
                      intermediate_size=1024, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=2,
                      head_dim=64, max_position_embeddings=512)
    params = random_quantized_params(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, 512, (2, 256), device=cuda)
    runs = []
    for ctx in (torch.inference_mode, torch.enable_grad):
        _build.reset_launches()
        with ctx():
            logits = modules.forward(cfg, params, tokens,
                                     dtype=torch.bfloat16)
        torch.cuda.synchronize()
        runs.append((logits, dict(_build.LAUNCHES)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert runs[1][1]["prefill_attention_dkv"] == 0
    assert runs[1][1]["w4a16_gemm"] == 7 * 2
    lora.add_lora(cfg, params, rank=4)
    adapters, base = lora.split_lora(params)
    _build.reset_launches()
    loss, grads = lora.lora_loss_and_grads(cfg, adapters, base, tokens,
                                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and len(grads) == 16
    assert {k: n for k, n in _build.LAUNCHES.items() if n} == {
        "w4a16_gemm": 14, "prefill_attention": 2,
        "prefill_attention_dkv": 2, "prefill_attention_dq": 2}


def test_mixtral_moe_block_under_grad_matches_the_cpu_plain_gradients(
        cuda):
    """A Mixtral-8x7B MoE block at published width (hidden 4096, 8 stacked
    experts of 14336, top-2) under grad on 512 tokens, the router biased
    toward expert 0 so that some experts get 256 rows or more and some
    fewer: each expert on its routed rows, K2 from 256 rows and K1 below
    (two launches each, gate_up and down; none for an expert with no
    rows), as the recorded routing implies; the output, dx and the router
    kernel's gradient against the CPU's plain route in f32 on the same
    expert choice, within 2e-2 of their scale (moe_block's limit: bf16
    products and expert outputs against f32)."""
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.nn import modules

    cfg = ModelConfig(model_type="mixtral", vocab_size=256, hidden_size=4096,
                      intermediate_size=14336, num_hidden_layers=1,
                      num_attention_heads=32, num_key_value_heads=8,
                      num_experts=8, num_experts_per_tok=2)
    g = torch.Generator(device=cuda).manual_seed(15)
    gate = torch.randn(4096, 8, device=cuda, generator=g) * 0.02
    gate[:, 0] += 5e-4
    mlp = {"gate": {"kernel": gate.to(torch.bfloat16)},
           "experts_stacked": {
               "gate_up_proj": stack(g, 8, 4096, 2 * 14336, 128, True, cuda),
               "down_proj": stack(g, 8, 14336, 4096, 128, True, cuda)}}
    x = (torch.randn(1, 512, 4096, device=cuda, generator=g) + 1.0).to(
        torch.bfloat16)
    dy = torch.randn(1, 512, 4096, device=cuda, generator=g).to(
        torch.bfloat16)
    route = modules.moe_route
    tape = []

    def taped(cfg_, p, xt, method="auto", topi=None):
        if tape:
            return route(cfg_, p, xt, method, tape[0].to(xt.device))
        out = route(cfg_, p, xt, method, topi)
        tape.append(out[1])
        return out

    def run(p, xin, dyin, method):
        xg = xin.clone().requires_grad_()
        gk = p["gate"]["kernel"].clone().requires_grad_()
        y = modules.moe_block(cfg, {**p, "gate": {"kernel": gk}}, xg,
                              method)
        dx, dg = torch.autograd.grad(y, [xg, gk], dyin)
        return y.detach(), dx, dg

    modules.moe_route = taped
    try:
        _build.reset_launches()
        got = run(mlp, x, dy, "auto")
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        cpu = {"gate": {"kernel": mlp["gate"]["kernel"].float().cpu()},
               "experts_stacked": {
                   n: {k: v.cpu() for k, v in lin.items()}
                   for n, lin in mlp["experts_stacked"].items()}}
        want = run(cpu, x.float().cpu(), dy.float().cpu(), "plain")
    finally:
        modules.moe_route = route
    rows = torch.bincount(tape[0].flatten().cpu(), minlength=8).tolist()
    expect = {}
    for n in rows:
        if n:
            k = "w4a16_gemm" if n >= gemm.WS_MIN_M else "w4a16_gemv"
            expect[k] = expect.get(k, 0) + 2
    assert "w4a16_gemm" in expect and "w4a16_gemv" in expect, rows
    assert launches == expect, (rows, launches)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert rel(a.cpu(), b) <= 2e-2


def test_v2_lite_latent_decode_folds_the_kv_b_adapter(cuda):
    """DeepSeek-V2-Lite's MLA at published width (g64, kv_b's dense leaf
    attached) with a kv_b adapter whose B is nonzero: a prefill of 64
    tokens, then one decode step through the latent cache on the kernel
    route (kv_b's dense weight with the adapter folded in, K1 for the
    linears) against the materialized per-head cache on the plain route,
    within 2e-2 of the output's scale (bf16 in other orders); the same
    step without the adapter differs by more than ten times that, so the
    check sees an adapter the fold drops."""
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.nn.fuse import attach_kv_b_dense
    from autoawq_tpu_torch.serve import generate as gen

    g = torch.Generator(device=cuda).manual_seed(16)
    cfg, layer = v2_lite_layer(g, cuda)
    attach_kv_b_dense(cfg, {"layers": [layer]})
    attn = layer["self_attn"]
    bare = {**attn, "kv_b_proj": dict(attn["kv_b_proj"])}
    attn["kv_b_proj"]["lora_a"] = torch.randn(
        512, 8, device=cuda, generator=g) * 0.25
    attn["kv_b_proj"]["lora_b"] = torch.randn(
        8, 16 * 256, device=cuda, generator=g) * 0.05
    x = torch.randn(1, 65, 2048, device=cuda, generator=g).to(
        torch.bfloat16)
    cos, sin = modules.rope_tables(cfg, torch.arange(65, device=cuda)[None])
    mask = modules.causal_mask(64, device=cuda)
    step_mask = torch.zeros(1, 1, 1, 80, device=cuda)
    step_mask[..., 65:] = -1e30

    def decode(p, latent, method):
        cache = gen.init_kv_cache(cfg, 1, 80, device=cuda,
                                  mla_latent=latent)[0]
        modules.mla_attention(cfg, p, x[:, :64], cos[:, :64], sin[:, :64],
                              mask, {**cache, "pos": 0}, method,
                              causal_prefill=True)
        return modules.mla_attention(cfg, p, x[:, 64:], cos[:, 64:],
                                     sin[:, 64:], step_mask,
                                     {**cache, "pos": 64}, method)[0]

    with torch.inference_mode():
        got = decode(attn, True, "auto")
        ref = decode(attn, False, "plain")
        lora_free = decode(bare, True, "auto")
    assert rel(got, ref) <= 2e-2
    assert rel(lora_free, ref) > 0.2


def _tiny_llava_on(dev):
    """A LLaVA at a small width (CLIP 2 layers, hidden 128, 16 image tokens;
    llama hidden 512, 8 / 8 heads x 64, 2 layers, W4 g128): its config,
    its tree on ``dev`` (int4 via utils/synth, the tower float, seed 0)
    and its image token."""
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.utils.synth import random_quantized_params

    cfg = ModelConfig(model_type="llama", vocab_size=512, hidden_size=512,
                      intermediate_size=1024, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=8,
                      head_dim=64, max_position_embeddings=1024)
    vcfg = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=2, patch_size=14, image_size=56,
                hidden_act="quick_gelu")
    g = torch.Generator().manual_seed(0)

    def n(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    def lin_f(k, m):
        return {"kernel": n(k, m), "bias": n(m)}

    def ln(h):
        return {"weight": torch.ones(h), "bias": torch.zeros(h)}

    h = vcfg["hidden_size"]
    tower = {"class_embedding": n(h),
             "patch_embedding": {"weight": n(h, 3, 14, 14)},
             "position_embedding": {"weight": n(17, h)},
             "pre_layernorm": ln(h), "post_layernorm": ln(h),
             "layers": [{"layer_norm1": ln(h), "layer_norm2": ln(h),
                         **{k: lin_f(h, h) for k in ("q_proj", "k_proj",
                                                     "v_proj", "out_proj")},
                         "fc1": lin_f(h, 256), "fc2": lin_f(256, h)}
                        for _ in range(2)]}
    lm = random_quantized_params(cfg, seed=0, fused=True, device="cpu")
    params = {"language_model": lm, "vision_tower": tower,
              "projector": {"linear_1": lin_f(h, 512),
                            "linear_2": lin_f(512, 512)}}
    from autoawq_tpu_torch.utils.tree import to_device

    return cfg, vcfg, to_device(params, dev), 500


def test_llava_prefill_from_embeds_matches_the_cpu_plain_path(cuda):
    """A 300-row multimodal prompt (16 image rows) prefilled from its
    spliced embeds on the card (K2 and K4 a layer, the CLIP tower in plain
    ops) against the same prompt on the CPU's plain path: the last row's
    logits within 2e-2 of their scale (bf16 arithmetic in both; the CPU
    twin's own bf16 distance bounds the difference), and the launches."""
    from autoawq_tpu_torch.models.vision import llava_input_embeds
    from autoawq_tpu_torch.serve import generate as gen

    cfg, vcfg, params, img = _tiny_llava_on(cuda)
    cpu = _tiny_llava_on("cpu")[2]
    ids = torch.randint(0, 400, (1, 300), generator=torch.Generator()
                        .manual_seed(1))
    ids[0, 5:21] = img
    px = torch.randn(1, 3, 56, 56, generator=torch.Generator().manual_seed(2))
    out = {}
    for dev, p, method in ((cuda, params, "auto"), ("cpu", cpu, "plain")):
        e = llava_input_embeds(cfg, vcfg, p, ids.to(dev), px.to(dev),
                               image_token_index=img, dtype=torch.bfloat16)
        cache = gen.init_kv_cache(cfg, 1, 310, device=dev)
        _build.reset_launches()
        logits, _ = gen.prefill(cfg, p["language_model"], ids.to(dev),
                                cache, method, embeds=e)
        out[str(dev)] = (logits.float().cpu(), dict(_build.LAUNCHES))
    got, launches = out[str(cuda)]
    ref = out["cpu"][0]
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert {k: v for k, v in launches.items() if v} == {
        "w4a16_gemm": 8, "prefill_attention": 2}


def test_llava_paged_embeds_request_decodes_as_generate(cuda):
    """One multimodal request through the paged engine on the card (K7 a
    layer a step) against ``generate`` from the same embeds: the first 8
    greedy tokens equal (one request, no near tie at this seed)."""
    from autoawq_tpu_torch.models.vision import llava_input_embeds
    from autoawq_tpu_torch.serve import generate as gen
    from autoawq_tpu_torch.serve.paged import PagedBatchingEngine

    cfg, vcfg, params, img = _tiny_llava_on(cuda)
    ids = torch.randint(0, 400, (1, 80), generator=torch.Generator()
                        .manual_seed(3), ).to(cuda)
    ids[0, 2:18] = img
    px = torch.randn(1, 3, 56, 56, generator=torch.Generator()
                     .manual_seed(4)).to(cuda)
    e = llava_input_embeds(cfg, vcfg, params, ids, px,
                           image_token_index=img, dtype=torch.bfloat16)
    lm = params["language_model"]
    want = gen.generate(cfg, lm, ids, 8, prompt_embeds=e)[0, 80:].tolist()
    eng = PagedBatchingEngine(cfg, lm, max_batch=2, page_size=16,
                              total_pages=32, pages_per_seq=8)
    eng.add_request("r", ids[0].cpu().numpy(), 8, prompt_embeds=e[0])
    _build.reset_launches()
    got = eng.run()["r"]
    assert got == want
    assert _build.LAUNCHES["paged_attn"] == 2 * 7


def _tiny_omni():
    """A Qwen2.5-Omni at small widths: the thinker (hidden 256, 2 layers,
    4 / 2 heads x 64, no window: K4 takes its prompt), a 2-layer audio
    tower (n_window 100), a 2-layer talker (4 / 2 heads x 128), a 2-layer
    DiT and a 3-stage BigVGAN."""
    return dict(
        model_type="qwen2_5_omni",
        thinker_config=dict(
            audio_token_index=500,
            text_config=dict(
                vocab_size=512, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=2048,
                rope_theta=1e6, rope_scaling={"type": "default",
                                              "mrope_section": [8, 12, 12]}),
            audio_config=dict(d_model=64, encoder_layers=2,
                              encoder_attention_heads=2, encoder_ffn_dim=128,
                              num_mel_bins=16, n_window=100,
                              output_dim=256)),
        talker_config=dict(vocab_size=96, hidden_size=128,
                           intermediate_size=256, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           head_dim=128, embedding_size=256),
        token2wav_config=dict(
            dit_config=dict(
                hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                head_dim=32, ff_mult=2, emb_dim=16, enc_emb_dim=8,
                enc_dim=12, enc_channels=[16, 16, 16, 16, 48],
                enc_kernel_sizes=[5, 3, 3, 3, 1],
                enc_dilations=[1, 2, 3, 4, 1], enc_attention_channels=8,
                enc_res2net_scale=2, enc_se_channels=8, mel_dim=10,
                num_embeds=64, repeats=2, block_size=24,
                look_ahead_layers=[1], look_backward_layers=[0]),
            bigvgan_config=dict(
                mel_dim=10, upsample_initial_channel=64,
                resblock_kernel_sizes=[3, 7],
                resblock_dilation_sizes=[[1, 3, 5]] * 2,
                upsample_rates=[5, 3, 2], upsample_kernel_sizes=[11, 7, 4])))


def _omni_parts(dev):
    import chip_smoke
    from autoawq_tpu_torch.models.config import ModelConfig
    from autoawq_tpu_torch.utils.synth import random_quantized_params
    from autoawq_tpu_torch.utils.tree import to_device

    raw = _tiny_omni()
    cfg = ModelConfig.from_hf_dict(raw)
    lm = random_quantized_params(cfg, seed=0, fused=True, device="cpu")
    extra = chip_smoke.synth_omni_on_card(raw, 1, "cpu")
    return raw, cfg, to_device(lm, dev), {k: v.to(dev)
                                          for k, v in extra.items()}


def test_omni_audio_prompt_launches_and_matches_the_cpu(cuda):
    """10 s of seeded mel through the audio tower (250 embeds) spliced into
    a 282-row prompt, prefilled on the card (K2 4 and K4 1 a layer: no
    window) and one decode step (K1 2 and K3 1 a layer), against the same
    prompt on the CPU's plain path: the prefill's logits within 2e-2 of
    their scale (bf16 in both; the llava case's bound)."""
    from autoawq_tpu_torch.models.audio import (audio_encoder,
                                                extra_audio_weights)
    from autoawq_tpu_torch.nn import modules
    from autoawq_tpu_torch.serve import generate as gen

    out = {}
    mel = torch.randn(16, 1000, generator=torch.Generator().manual_seed(2))
    for dev, method in ((cuda, "auto"), (torch.device("cpu"), "plain")):
        raw, cfg, lm, extra = _omni_parts(dev)
        audio = audio_encoder(raw["thinker_config"]["audio_config"],
                              extra_audio_weights({"_extra": extra}),
                              mel.to(dev), 1000, device=dev)
        assert audio.shape == (250, 256)
        ids = torch.randint(0, 400, (1, 282), generator=torch.Generator()
                            .manual_seed(3)).to(dev)
        ids[0, 16:266] = 500
        e = modules.embed(cfg, lm, ids, torch.bfloat16)
        e[:, 16:266] = audio.to(torch.bfloat16)
        cache = gen.init_kv_cache(cfg, 1, 290, device=dev)
        _build.reset_launches()
        logits, _ = gen.prefill(cfg, lm, ids, cache, method, embeds=e)
        prefill = dict(_build.LAUNCHES)
        _build.reset_launches()
        gen.decode_step(cfg, lm, logits.argmax(-1)[:, None], cache, 282,
                        method)
        out[dev.type] = (logits.float().cpu(), prefill,
                         dict(_build.LAUNCHES))
    got, prefill, step = out["cuda"]
    ref = out["cpu"][0]
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert {k: v for k, v in prefill.items() if v} == {
        "w4a16_gemm": 8, "prefill_attention": 2}
    assert {k: v for k, v in step.items() if v} == {"w4a16_gemv": 4,
                                                    "fused_mlp": 2}


def test_omni_talker_prefill_takes_k4_a_layer(cuda):
    """The talker (bf16, 4 / 2 heads x 128 over a 128-wide stream) on a
    282-row prompt of thinker-width embeds: ``generate_codec`` launches K4
    once a layer, in the prefill, and nothing else; the prefill's logits
    within 2e-2 of their scale of the CPU's plain path in bf16."""
    from autoawq_tpu_torch.models.talker import OmniTalker
    from autoawq_tpu_torch.serve import generate as gen

    g = torch.Generator().manual_seed(4)
    e = torch.randn(1, 282, 256, generator=g) * 0.3
    reply = torch.randn(1, 4, 256, generator=g) * 0.3
    logits = {}
    for dev, method in ((cuda, "auto"), (torch.device("cpu"), "plain")):
        raw, _, _, extra = _omni_parts(dev)
        talker = OmniTalker(raw["talker_config"], extra, device=dev)
        cache = gen.init_kv_cache(talker.cfg, 1, 283, device=dev)
        logits[dev.type] = gen.prefill(
            talker.cfg, talker.params, torch.zeros((1, 282), dtype=torch.long,
                                                   device=dev), cache,
            method, embeds=talker.project(e.to(dev)).to(torch.bfloat16)
        )[0].float().cpu()
        if dev.type == "cuda":
            _build.reset_launches()
            codes = talker.generate_codec(e.to(dev), reply.to(dev), 8,
                                          dtype=torch.bfloat16)
            assert codes.shape == (1, 8)
            assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
                "prefill_attention": 2}
    ref = logits["cpu"]
    assert (logits["cuda"] - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_token2wav_f32_on_the_card_matches_the_cpu(cuda):
    """token2wav on the card with TF32 switched on globally: its entry
    points turn TF32 off in their scope. The DiT forward (with CFG) and the
    vocoder, each within twice the CPU's f32 distance from the CPU's f64 run
    (+1e-6 of the scale; TF32 would sit ~1e-3 away); the whole path (4 RK4
    steps with guidance, then BigVGAN) and its mel within 1e-4 of the CPU's
    f32 (the order of f32 sums through the steps; 1.4e-5 in the first run
    on the card), and the flags as they were afterwards."""
    from autoawq_tpu_torch.models import token2wav as t2w

    g = torch.Generator().manual_seed(5)
    kw = dict(num_steps=4, guidance_scale=0.5, sway_coefficient=-1.0)
    code = torch.randint(0, 64, (1, 12), generator=g)
    cond = torch.randn(1, 8, generator=g)
    ref_mel = torch.randn(1, 40, 10, generator=g)
    noise = torch.randn(1, 24, 10, generator=g)
    mel_in = torch.randn(1, 10, 16, generator=g)

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        for dev in (cuda, torch.device("cpu")):
            raw, _, _, extra = _omni_parts(dev)
            t2 = raw["token2wav_config"]
            dcfg, bcfg = t2["dit_config"], t2["bigvgan_config"]
            dit = t2w.token2wav_weights(extra, "code2wav_dit_model")
            voc = t2w.token2wav_weights(extra, "code2wav_bigvgan_model")
            args = [a.to(dev) for a in (code, cond, ref_mel, noise)]
            spk = args[1][:, None].expand(-1, 24, -1)
            runs = [
                lambda dt: t2w.dit_forward(dit, dcfg, args[3], args[2], spk,
                                           args[0], 0.25, device=dev,
                                           dtype=dt),
                lambda dt: t2w.bigvgan_forward(voc, bcfg, mel_in.to(dev),
                                               device=dev, dtype=dt)]
            dts = [torch.float32] + ([torch.float64] if dev.type == "cpu"
                                     else [])
            out[dev.type] = {
                "parts": [[r(dt).cpu() for dt in dts] for r in runs],
                "mel": t2w.dit_sample(dit, dcfg, args[1], args[2], args[0],
                                      args[3], device=dev, **kw).cpu(),
                "wav": t2w.token2wav(extra, dcfg, bcfg, *args, device=dev,
                                     **kw).cpu()}
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    for (card,), (c32, c64) in zip(out["cuda"]["parts"],
                                   out["cpu"]["parts"]):
        assert rel(card, c64) <= 2 * rel(c32, c64) + 1e-6
    for key in ("mel", "wav"):
        got, ref = out["cuda"][key], out["cpu"][key]
        assert got.shape == ref.shape
        assert rel(got, ref) <= 1e-4
    assert out["cpu"]["wav"].shape == (1, 24 * 30)


def test_talker_codes_reach_token2wav_unchanged(cuda):
    """The talker's codes as they are (its vocabulary, 96, is wider than
    the DiT's table of 65 rows; one code forced past it) go into
    ``token2wav`` on the card: no device-side assert, a finite waveform
    within 1e-5 of its scale of the run on the codes clamped to the table
    (what JAX's gather reads; two runs on the card part in the last bits,
    as cuDNN's sums are not bit-reproducible), and within 1e-4 of the
    CPU's on the same codes."""
    from autoawq_tpu_torch.models import token2wav as t2w
    from autoawq_tpu_torch.models.talker import OmniTalker

    g = torch.Generator().manual_seed(6)
    e = torch.randn(1, 40, 256, generator=g) * 0.3
    reply = torch.randn(1, 4, 256, generator=g) * 0.3
    cond = torch.randn(1, 8, generator=g)
    ref_mel = torch.randn(1, 40, 10, generator=g)
    noise = torch.randn(1, 24, 10, generator=g)
    kw = dict(num_steps=2, guidance_scale=0.5, sway_coefficient=-1.0)
    raw, _, _, extra = _omni_parts(cuda)
    talker = OmniTalker(raw["talker_config"], extra, device=cuda)
    codes = talker.generate_codec(e.to(cuda), reply.to(cuda), 12,
                                  dtype=torch.bfloat16).clone()
    codes[0, 3] = 95
    t2 = raw["token2wav_config"]
    dcfg, bcfg = t2["dit_config"], t2["bigvgan_config"]
    rows = dcfg["num_embeds"] + 1
    assert int(codes.max()) >= rows

    def wav(c, dev, parts):
        return t2w.token2wav(parts, dcfg, bcfg, c.to(dev), cond.to(dev),
                             ref_mel.to(dev), noise.to(dev), device=dev,
                             **kw).cpu()

    got = wav(codes, cuda, extra)
    assert torch.isfinite(got).all()
    clamped = wav(codes.clamp(0, rows - 1), cuda, extra)
    assert float((got - clamped).abs().max() / clamped.abs().max()) <= 1e-5
    _, _, _, cpu_extra = _omni_parts(torch.device("cpu"))
    ref = wav(codes.cpu(), torch.device("cpu"), cpu_extra)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4
