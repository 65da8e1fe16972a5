"""The W4A16 twin (ops/gemm.awq_matmul_plain, the CPU path of kernels K1/K2)
against the JAX package's awq_matmul_jnp and awq_matmul_pallas (interpret
mode), on the same nibbles.

Tolerances: f32 inputs differ only in summation order, 1e-5 of the output
scale. bf16: the twin and awq_matmul_jnp both round dequantized weights and
the output to bf16, so they agree within one bf16 ulp of the output scale
(2^-8 ~ 4e-3, taken as 8e-3). The Pallas kernel applies scales in f32 after
the dot (group-factored), so against it bf16 gets 2e-2 of the scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.core import packing as jp
from autoawq_tpu.ops.gemm import awq_matmul_jnp, dequantize_planar
from autoawq_tpu.ops.pallas_gemm import awq_matmul_pallas
from autoawq_tpu_torch.core.packing import planar_to_port
from autoawq_tpu_torch.ops import gemm

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def make(rng, k, n, gs, zp, k_pad=False):
    """Planar (JAX) and port triples of one random quantized weight."""
    q4 = rng.integers(0, 16, (k, n))
    z4 = rng.integers(0, 16, (k // gs, n))
    sc = ((rng.random((k // gs, n)) + 0.5) * 0.01).astype(np.float32)
    if k_pad:
        q4, sc, z4 = jp.pad_k_nibbles(q4, sc, z4, gs)
    planar = (jp.pack_planar(q4), jp.pad_scales_planar(sc),
              jp.pack_planar(z4) if zp else None)
    port = planar_to_port(*planar, n)
    return planar, port


def close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def to_torch(x, dt):
    return torch.from_numpy(x).to(dt)


@pytest.mark.parametrize("m", [1, 8, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("gs,zp", [(128, True), (64, True), (32, False)])
def test_twin_matches_awq_matmul_jnp(rng, m, dtype, gs, zp):
    k, n = 256, 320
    (qw, sc, qz), port = make(rng, k, n, gs, zp)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    ref = awq_matmul_jnp(jnp.asarray(x, jdt), jnp.asarray(qw),
                         jnp.asarray(sc), None if qz is None else
                         jnp.asarray(qz), out_features=n,
                         bias=jnp.asarray(bias))
    for method in ("plain", "auto"):  # auto on a CPU tensor = the twin
        got = gemm.awq_matmul(to_torch(x, tdt), *port, out_features=n,
                              bias=torch.from_numpy(bias), method=method)
        assert got.dtype == tdt and got.shape == (m, n)
        close(got.float(), np.asarray(ref, np.float32),
              1e-5 if dtype == "f32" else 8e-3)


@pytest.mark.parametrize("m", [1, 8, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_twin_matches_pallas_interpret(rng, m, dtype):
    k, n = 256, 1024
    (qw, sc, qz), port = make(rng, k, n, 128, True)
    x = rng.standard_normal((m, k)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    ref = awq_matmul_pallas(jnp.asarray(x, jdt), jnp.asarray(qw),
                            jnp.asarray(sc), jnp.asarray(qz), out_features=n,
                            interpret=True)
    got = gemm.awq_matmul(to_torch(x, tdt), *port, method="plain")
    # the Pallas WS mode (M >= 256) dequantizes into bf16 scratch even for
    # f32 inputs: f32 gets the bf16 tolerance there
    tol = 1e-4 if dtype == "f32" and m < 256 else 2e-2
    close(got.float(), np.asarray(ref, np.float32), tol)


def test_dequantize_matches_jax(rng):
    (qw, sc, qz), port = make(rng, 256, 320, 64, True)
    ref = dequantize_planar(jnp.asarray(qw), jnp.asarray(sc), jnp.asarray(qz),
                            out_features=320, dtype=jnp.float32)
    got = gemm.dequantize(*[port[0], port[1], port[2]])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_k_padded_layout_pads_x(rng):
    """K=320 at g64 pads to 384 (falcon-style); x is zero-padded exactly."""
    (qw, sc, qz), port = make(rng, 320, 256, 64, True, k_pad=True)
    assert port[0].shape[0] * 8 == 384
    x = rng.standard_normal((3, 320)).astype(np.float32)
    ref = awq_matmul_jnp(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sc),
                         jnp.asarray(qz), out_features=256)
    got = gemm.awq_matmul(torch.from_numpy(x), *port)
    close(got, np.asarray(ref), 1e-5)


def test_wrappers_use_twin_only_on_cpu(rng):
    """On a CPU tensor K1 / K2 wrappers return the twin, and launch no
    kernel (the launch counts stay put)."""
    from autoawq_tpu_torch.ops import _build

    _, port = make(rng, 256, 96, 32, True)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    before = dict(_build.LAUNCHES)
    ref = gemm.awq_matmul_plain(x, *port)
    assert torch.equal(gemm.w4a16_gemv(x, *port), ref)
    assert torch.equal(gemm.w4a16_gemm(x, *port), ref)
    assert _build.LAUNCHES == before
    with pytest.raises(ValueError):
        gemm.awq_matmul(x, *port, method="pallas")


@pytest.mark.parametrize("loader", ["jax_tree", "fused"])
def test_loaders_build_k2_ready_ragged_width(rng, loader):
    """A linear of N = 2502 built by the port's loaders (a JAX tree's
    planar triple through ``convert``, as ``utils/synth`` builds every
    linear, and two 1251-wide members through ``nn/fuse``; AutoAWQ
    checkpoints hold N % 8 == 0 only) comes out K2-ready: columns padded once to a multiple of 4, contiguous
    and 16-byte aligned, so K2's wrapper copies nothing. ``awq_matmul``
    with ``out_features`` still equals the JAX package's on the CPU."""
    from autoawq_tpu_torch.convert import lin_from_planar
    from autoawq_tpu_torch.nn.fuse import _fuse

    k, n, gs = 256, 2502, 64
    q4 = rng.integers(0, 16, (k, n))
    z4 = rng.integers(0, 16, (k // gs, n))
    sc = ((rng.random((k // gs, n)) + 0.5) * 0.01).astype(np.float16)
    if loader == "jax_tree":
        lin = lin_from_planar({"qweight": jp.pack_planar(q4),
                               "scales": jp.pad_scales_planar(
                                   sc.astype(np.float32)),
                               "qzeros": jp.pack_planar(z4)}, n)
    else:
        h = n // 2
        lin = _fuse([lin_from_planar({"qweight": jp.pack_planar(q[:, sl]),
                                      "scales": jp.pad_scales_planar(
                                          sc[:, sl].astype(np.float32)),
                                      "qzeros": jp.pack_planar(z[:, sl])}, h)
                     for q, z, sl in [(q4, z4, slice(0, h)),
                                      (q4, z4, slice(h, n))]], [h, h])
    port = (lin["qweight"], lin["scales"], lin["qzeros"])
    for t in port:
        assert t.shape[-1] == 2504 and t.is_contiguous()
        assert t.data_ptr() % 16 == 0
    np.testing.assert_array_equal(
        gemm.dequantize(*port)[:, n:].numpy(), 0.0)  # pad columns are 0
    x = rng.standard_normal((5, k)).astype(np.float32)
    ref = awq_matmul_jnp(jnp.asarray(x), jnp.asarray(jp.pack_planar(q4)),
                         jnp.asarray(jp.pad_scales_planar(
                             sc.astype(np.float32))),
                         jnp.asarray(jp.pack_planar(z4)), out_features=n)
    got = gemm.awq_matmul(torch.from_numpy(x), *port, out_features=n)
    assert got.shape == (5, n)
    close(got, np.asarray(ref), 1e-5)
