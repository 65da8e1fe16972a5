"""The host side of the tensor-core GEMV (K1, and K6's decode instance) and
of K6's instance choice, and the order of K1's arithmetic.

K1 (``csrc/w4a16_gemv.cuh``) sums ``(q - z) * x`` exactly per quantization
group in f32 (q - z is an exact bf16 integer, x bf16, the products exact)
and scales each group's sum once by s; the twin and the JAX jnp oracle
round ``(q - z) * s`` to bf16 first, the JAX Pallas kernel takes the dot
with the raw nibbles, subtracts ``z * sum(x)`` and scales per group. A
test-local f32 mirror of K1's order is held against JAX's
``awq_matmul_pallas(interpret=True)`` (2e-3 of the output scale: the same
per-group factoring, bf16 output rounding apart) and against the twin at
K1's own tolerance on the card, 1e-2 of the output scale (``TOL`` in
``chip_smoke.py``), which the reordering must sit inside: both sides
round to bf16, so they differ by at most one bf16 ulp of the output's
scale, 2^-7 of it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoawq_tpu.core import packing as jp
from autoawq_tpu.ops.pallas_gemm import awq_matmul_pallas
from autoawq_tpu_torch.core.packing import planar_to_port
from autoawq_tpu_torch.ops import gemm, moe_gemm

SMS = 132  # the H100 SXM's SMs


def kernel_order_mirror(x, q4, z4, sc, gs):
    """K1's arithmetic in f32: bf16 x, exact (q - z), one f32 sum per
    group, scaled by s once; then rounded to bf16 as the kernel stores."""
    xb = torch.from_numpy(x).to(torch.bfloat16).double()
    k, n = q4.shape
    out = torch.zeros(x.shape[0], n, dtype=torch.float64)
    for g in range(k // gs):
        rows = slice(g * gs, (g + 1) * gs)
        qz = torch.from_numpy((q4[rows] - z4[g][None, :]).astype(np.float64))
        part = (xb[:, rows] @ qz).float()  # the group's f32 sum
        out += part.double() * torch.from_numpy(sc[g].astype(np.float64))
    return out.float().to(torch.bfloat16).float()


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("gs,zp", [(128, True), (64, True), (32, False)])
def test_kernel_order_within_tolerance(rng, m, gs, zp):
    k, n = 512, 256
    q4 = rng.integers(0, 16, (k, n))
    z4 = rng.integers(0, 16, (k // gs, n)) if zp else np.full(
        (k // gs, n), 8)
    sc = ((rng.random((k // gs, n)) + 0.5) * 0.01).astype(np.float32)
    planar = (jp.pack_planar(q4), jp.pad_scales_planar(sc),
              jp.pack_planar(z4) if zp else None)
    port = planar_to_port(*planar, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    mirror = kernel_order_mirror(x, q4, z4, sc, gs).numpy()
    xb = jnp.asarray(x, jnp.bfloat16)
    pallas = np.asarray(awq_matmul_pallas(
        xb, *(None if a is None else jnp.asarray(a) for a in planar),
        out_features=n, interpret=True), np.float32)
    twin = gemm.awq_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                                 *port).float().numpy()
    scale = np.abs(twin).max()
    assert np.abs(mirror - pallas).max() <= 2e-3 * scale
    # both round to bf16 from f32 values ~1e-3 apart: at most one bf16 ulp
    # of the output scale (2^-7 of it), inside K1's 1e-2 on the card
    assert np.abs(mirror - twin).max() <= 2 ** -7 * scale


SHAPES = [(1, 2048, 2560), (8, 2048, 11264), (1, 5632, 2048),
          (1, 4096, 6144), (8, 4096, 4096), (64, 4096, 6144),
          (7, 14336, 4096), (9, 2048, 2048), (255, 2048, 2048),
          (256, 2048, 2560), (300, 4096, 4096), (1, 64, 40)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_gemv_plan(m, k, n):
    """Every warp's n8 tiles hold its rows, the CTA's row groups of 32
    cover min(m, 256) rows (the smallest power of two that does), the
    cluster splits K only while the CTAs are fewer than the plan's target,
    and never below two 32-deep chunks a warp."""
    nt, rg, csize = gemm.gemv_plan(m, k, n, 1, SMS)
    rows = min(m, 256)
    assert rg in (1, 2, 4, 8) and csize in (1, 2, 4, 8)
    assert 8 * nt >= min(rows, 32) and (nt == 1 or 8 * nt // 2 < rows)
    assert 32 * rg >= rows and (rg == 1 or 32 * rg // 2 < rows)
    assert nt == 4 or rg == 1  # several row groups: 32 rows a warp
    cols, halves = gemm.gemv_cta(nt, rg)
    assert (cols // 32) * rg * halves == 8  # 8 warps of 32 columns
    assert cols == (32 if nt < 4 else {1: 128, 2: 32, 4: 64, 8: 32}[rg])
    ctas = -(-n // cols) * -(-m // 256)
    chunks = k // 32
    target = SMS // 2 if halves >= 4 else SMS
    if csize > 1:
        assert ctas * csize // 2 < target
        assert chunks >= 2 * csize * halves
    assert (csize == 4 or ctas * csize >= target
            or chunks < 4 * csize * halves)


@pytest.mark.parametrize("blocks", [1, 2, 10])
def test_gemv_plan_for_expert_blocks(blocks):
    """K6's decode instance: one n8 tile and one row group a block (the
    kernel's fixed shape); more live blocks need no larger cluster."""
    plans = [gemm.gemv_plan(8, k, n, blocks, SMS)
             for k, n in ((4096, 28672), (14336, 4096))]
    for nt, rg, csize in plans:
        assert (nt, rg) == (1, 1)
        assert csize >= 1
    assert plans[1][2] >= gemm.gemv_plan(8, 14336, 4096, blocks + 1, SMS)[2]


def test_tile_rows_for_every_block_size():
    """Every block size pick_block_m can return gets the smallest K6
    instance that holds it: the GEMV for 8 rows, else a wgmma tile of
    16 / 32 / 64 / 128 rows."""
    seen = set()
    for e in (4, 8, 64):
        for tk in range(1, 40000, 7):
            seen.add(moe_gemm.pick_block_m(tk, e))
    assert seen == set(range(8, 129, 8))
    for bm in sorted(seen):
        tok = moe_gemm.tile_rows(bm)
        if bm <= 8:
            assert tok == 0
        else:
            assert tok in (16, 32, 64, 128) and tok >= bm
            assert tok == 16 or tok // 2 < bm
    with pytest.raises(ValueError):
        moe_gemm.tile_rows(136)
