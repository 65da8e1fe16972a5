"""Layout conversions into the port's layout are bit-exact on the nibbles:
planar (JAX package) -> port and AutoAWQ GEMM -> port, at g32/64/128, with
and without zero points, including a K-padded planar layout. No tolerance:
integers must match exactly."""

import numpy as np
import pytest
import torch

from autoawq_tpu.core import packing as jp
from autoawq_tpu_torch.core import packing as pp


@pytest.mark.parametrize("k,n", [(64, 96), (256, 1024), (512, 2560),
                                 (24, 40)])
def test_planar_codec_copy_matches_jax(rng, k, n):
    q4 = rng.integers(0, 16, (k, n))
    words = jp.pack_planar(q4)
    np.testing.assert_array_equal(pp.unpack_planar(words, n),
                                  jp.unpack_planar(words, n))
    assert pp.padded_out_features(n) == jp.padded_out_features(n)
    assert pp.lane_block(pp.padded_out_features(n)) == jp.lane_block(
        jp.padded_out_features(n))
    for g in (32, 64, 128):
        assert pp.padded_in_features(k, g) == jp.padded_in_features(k, g)


@pytest.mark.parametrize("k,n", [(64, 96), (256, 1024), (128, 8)])
def test_awq_codec_copy_matches_jax(rng, k, n):
    q4 = rng.integers(0, 16, (k, n))
    np.testing.assert_array_equal(pp.pack_awq(q4), jp.pack_awq(q4))
    words = jp.pack_awq(q4)
    np.testing.assert_array_equal(pp.unpack_awq(words), jp.unpack_awq(words))
    np.testing.assert_array_equal(pp.unpack_awq(words), q4)


@pytest.mark.parametrize("rows", [8, 16, 13, 1])
def test_port_pack_roundtrip(rng, rows):
    q4 = rng.integers(0, 16, (rows, 40))
    words = pp.pack_port(q4)
    assert words.dtype == torch.int32
    assert words.shape == (-(-rows // 8), 40)
    np.testing.assert_array_equal(pp.unpack_port(words, rows).numpy(), q4)
    # nibble i of word (r, n) is element (8r + i, n)
    w = int(words[0, 3]) & 0xFFFFFFFF
    for i in range(min(8, rows)):
        assert (w >> (4 * i)) & 0xF == q4[i, 3]


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("zp", [True, False])
def test_planar_to_port_bit_exact(rng, gs, zp):
    k, n = 512, 2560  # 2560 pads to 3072 in the planar layout
    g = k // gs
    q4 = rng.integers(0, 16, (k, n))
    z4 = rng.integers(0, 16, (g, n))
    sc = (rng.random((g, n)) + 0.5).astype(np.float32)
    qw, s, qz = pp.planar_to_port(
        jp.pack_planar(q4), jp.pad_scales_planar(sc),
        jp.pack_planar(z4) if zp else None, n)
    np.testing.assert_array_equal(pp.unpack_port(qw).numpy(), q4)
    np.testing.assert_array_equal(s.numpy(), sc)
    if zp:
        assert qz.shape == (-(-g // 8), n)
        np.testing.assert_array_equal(pp.unpack_port(qz, g).numpy(), z4)
    else:
        assert qz is None


def test_planar_to_port_keeps_k_padding(rng):
    """A K-padded planar layout (core/packing.pad_k_nibbles: K=320 at g64
    pads to 384 with nibbles 8 and zero points 8) keeps its pad rows."""
    k, n, gs = 320, 256, 64
    q4 = rng.integers(0, 16, (k, n))
    z4 = rng.integers(0, 16, (k // gs, n))
    sc = (rng.random((k // gs, n)) + 0.5).astype(np.float32)
    q4p, scp, z4p = jp.pad_k_nibbles(q4, sc, z4, gs)
    assert q4p.shape[0] == 384
    qw, s, qz = pp.planar_to_port(jp.pack_planar(q4p),
                                  jp.pad_scales_planar(scp),
                                  jp.pack_planar(z4p), n)
    np.testing.assert_array_equal(pp.unpack_port(qw).numpy(), q4p)
    np.testing.assert_array_equal(pp.unpack_port(qz, 6).numpy(), z4p)
    np.testing.assert_array_equal(s.numpy(), scp)


@pytest.mark.parametrize("gs", [32, 64, 128])
def test_awq_to_port_bit_exact(rng, gs):
    k, n = 256, 320
    g = k // gs
    q4 = rng.integers(0, 16, (k, n))
    z4 = rng.integers(0, 16, (g, n))
    sc = (rng.random((g, n)) + 0.5).astype(np.float16)
    qw, s, qz = pp.awq_to_port(jp.pack_awq(q4), jp.pack_awq(z4), sc)
    np.testing.assert_array_equal(pp.unpack_port(qw).numpy(), q4)
    np.testing.assert_array_equal(pp.unpack_port(qz, g).numpy(), z4)
    np.testing.assert_array_equal(s.numpy(), sc.astype(np.float32))
