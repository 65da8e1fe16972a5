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
the limit is two)."""

import numpy as np
import pytest
import torch

from autoawq_tpu_torch.core.packing import pack_port
from autoawq_tpu_torch.ops import _build, attention, fused_mlp, gemm

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
