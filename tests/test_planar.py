"""Planar engine (ops.planar) — oracle bit-exactness + routing.

The planar engine is plain XLA, so these tests compile and run the same
program the GPU runs.
"""

import numpy as np
import pytest

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.oracle import oracle_decode, oracle_encode
from rustyhgi_tpu.ops import planar, pyramid
from rustyhgi_tpu.ops.quantizers import QuantizationLevel, quantize_fn

MATRIX = [
    ((48, 64), 3, QuantizationLevel.LOSSLESS, "crossed"),
    ((48, 64), 3, QuantizationLevel.MEDIUM, "crossed"),
    ((37, 53), 4, QuantizationLevel.HIGH, "crossed"),
    ((32, 48), 2, QuantizationLevel.LOW, "left_top"),
    ((65, 17), 5, QuantizationLevel.LOSSLESS, "crossed"),
    ((128, 96), 6, QuantizationLevel.MEDIUM, "crossed"),  # step > ragged dims
]


@pytest.mark.parametrize("shape,levels,preset,pred", MATRIX)
def test_planar_grid_bit_exact(rng, shape, levels, preset, pred):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    quant = quantize_fn(preset)
    grid, recon = planar.encode_plane_planar(img, levels, quant, pred)
    assert np.array_equal(np.asarray(grid), oracle_encode(img, levels, preset, pred))
    dec = planar.decode_plane_planar(np.asarray(grid), levels, pred)
    assert np.array_equal(
        np.asarray(dec), oracle_decode(np.asarray(grid), levels, pred)
    )
    assert np.array_equal(np.asarray(dec), np.asarray(recon))


@pytest.mark.parametrize(
    "shape,levels,preset,pred",
    [m for m in MATRIX if m[3] == "crossed"],
)
def test_planar_subbands_bit_exact(rng, shape, levels, preset, pred):
    import jax

    img = rng.integers(0, 256, shape, dtype=np.uint8)
    quant = quantize_fn(preset)
    a_ref, s_ref, recon_ref = pyramid.encode_subbands(
        jax.numpy.asarray(img), levels, quant
    )
    a, s, recon = planar.encode_subbands_planar(img, levels, quant, pred)
    assert np.array_equal(np.asarray(a), np.asarray(a_ref))
    for quads, quads_ref in zip(s, s_ref):
        for q, q_ref in zip(quads, quads_ref):
            assert np.array_equal(np.asarray(q), np.asarray(q_ref))
    dec = planar.decode_subbands_planar(a, s, shape, levels, pred)
    assert np.array_equal(np.asarray(dec), np.asarray(recon_ref))


def test_planar_batch_matches_per_plane(rng):
    imgs = rng.integers(0, 256, (4, 40, 56), dtype=np.uint8)
    quant = quantize_fn(QuantizationLevel.MEDIUM)
    grids, recons = planar.encode_plane_planar(imgs, 3, quant)
    for i in range(4):
        assert np.array_equal(
            np.asarray(grids)[i],
            oracle_encode(imgs[i], 3, QuantizationLevel.MEDIUM),
        )
    dec = planar.decode_plane_planar(np.asarray(grids), 3)
    assert np.array_equal(np.asarray(dec), np.asarray(recons))


def test_planar_large_batch_chunked(rng):
    """A 20-plane batch in one program — bytes unchanged per plane."""
    import jax

    imgs = rng.integers(0, 256, (20, 40, 48), dtype=np.uint8)
    quant = quantize_fn(QuantizationLevel.MEDIUM)
    grids, recons = planar.encode_plane_planar(imgs, 3, quant)
    for i in range(20):
        assert np.array_equal(
            np.asarray(grids)[i],
            oracle_encode(imgs[i], 3, QuantizationLevel.MEDIUM),
        ), i
    dec = planar.decode_plane_planar(np.asarray(grids), 3)
    assert np.array_equal(np.asarray(dec), np.asarray(recons))
    a, s, _ = planar.encode_subbands_planar(imgs, 3, quant)
    a1, s1, _ = jax.vmap(
        lambda im: pyramid.encode_subbands(im, 3, quant)
    )(jax.numpy.asarray(imgs))
    assert np.array_equal(np.asarray(a), np.asarray(a1))
    for quads, quads_ref in zip(s, s1):
        for q, q_ref in zip(quads, quads_ref):
            assert np.array_equal(np.asarray(q), np.asarray(q_ref))
    dsb = planar.decode_subbands_planar(a, s, (40, 48), 3)
    assert np.array_equal(np.asarray(dsb), np.asarray(recons))


def test_backend_planar_forced(rng):
    img = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    codec = HGICodec(3, "medium", backend="planar")
    grid, recon = codec.encode_plane(img)
    assert np.array_equal(
        np.asarray(grid), oracle_encode(img, 3, QuantizationLevel.MEDIUM)
    )
    assert np.array_equal(np.asarray(codec.decode_plane(grid)), np.asarray(recon))
    a, s, _ = codec.encode_subbands(img)
    dec = codec.decode_subbands(a, s, img.shape)
    assert np.array_equal(np.asarray(dec), np.asarray(recon))
    blob = codec.write_fast(img)
    from rustyhgi_tpu.utils.container import read_thgi

    assert np.array_equal(read_thgi(blob).grid, np.asarray(grid))


def test_backend_planar_out_of_envelope_raises():
    codec = HGICodec(1, "lossless", backend="planar")  # levels<2 unsupported
    with pytest.raises(ValueError, match="does not cover"):
        codec.encode_plane(np.zeros((16, 16), np.uint8))


def test_planar_large_plane_matches_xla_engine(rng):
    """A ~2 MPix single plane (beyond oracle-speed territory): the
    planar engine must match the independently-trusted XLA engine
    byte-for-byte on grid, recon, and decode."""
    img = rng.integers(0, 256, (1024, 2048), dtype=np.uint8)
    quant = quantize_fn(QuantizationLevel.MEDIUM)
    g1, r1 = planar.encode_plane_planar(img, 5, quant)
    g2, r2 = pyramid.encode_plane(img, 5, quant)
    assert np.array_equal(np.asarray(g1), np.asarray(g2))
    assert np.array_equal(np.asarray(r1), np.asarray(r2))
    d1 = planar.decode_plane_planar(np.asarray(g1), 5)
    assert np.array_equal(np.asarray(d1), np.asarray(r2))


def test_planar_engine_exports_and_reloads(rng):
    """jax.export round-trip of the production (planar) encoder.

    Serving ships serialized StableHLO artifacts (HGICodec.export_*);
    the planar graph must survive
    serialize -> deserialize -> call with identical bytes.
    """
    from rustyhgi_tpu.models.codec import load_exported

    imgs = rng.integers(0, 256, (20, 48, 64), dtype=np.uint8)
    codec = HGICodec(3, "medium", backend="planar")
    # A batched 20-plane shape: the serialized graph vmaps the planes.
    blob = codec.export_encoder(imgs.shape)
    fn = load_exported(blob)
    grids, recons = fn(imgs)
    for i in range(20):
        assert np.array_equal(
            np.asarray(grids)[i],
            oracle_encode(imgs[i], 3, QuantizationLevel.MEDIUM),
        ), i
    dec_blob = codec.export_decoder(imgs.shape)
    dec = load_exported(dec_blob)(np.asarray(grids))
    assert np.array_equal(np.asarray(dec), np.asarray(recons))


def test_planar_supported_has_no_width_cap():
    q = quantize_fn(QuantizationLevel.LOSSLESS)
    assert planar.supported_planar(4, 64, 32768, q, "crossed")
