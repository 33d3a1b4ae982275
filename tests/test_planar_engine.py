"""Planar engine (ops.planar) vs the oracle and the dyadic engine.

The invariant is CLAUDE.md's: device encode bit-exact vs
rustyhgi_tpu/oracle.py for every shape/levels/preset/predictor, and the
two device engines byte-identical to each other.  The engine compiles as
plain XLA, so these tests run the same program the GPU runs.
"""

import numpy as np
import pytest

from rustyhgi_tpu.oracle import oracle_decode, oracle_encode
from rustyhgi_tpu.ops import pyramid
from rustyhgi_tpu.ops.engine import choose_engine
from rustyhgi_tpu.ops.planar import (
    decode_plane_planar,
    decode_subbands_planar,
    encode_plane_planar,
    encode_subbands_planar,
    supported_planar,
)
from rustyhgi_tpu.ops.quantizers import (
    LUTQuantizer,
    QuantizationLevel,
    quantize_fn,
)

RNG = np.random.default_rng(7)


def _img(h, w):
    return RNG.integers(0, 256, (h, w), np.uint8)


@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (96, 128), (130, 68)])
@pytest.mark.parametrize("levels", [2, 3, 4])
@pytest.mark.parametrize(
    "preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM]
)
def test_encode_decode_bit_exact(shape, levels, preset):
    img = _img(*shape)
    q = quantize_fn(preset)
    grid_o = oracle_encode(img, levels, preset)
    grid_p, recon_p = encode_plane_planar(img, levels, q, "crossed")
    assert np.array_equal(np.asarray(grid_p), grid_o)
    dec_o = oracle_decode(grid_o, levels)
    assert np.array_equal(
        np.asarray(decode_plane_planar(grid_o, levels, "crossed")), dec_o
    )
    if recon_p is not None:
        assert np.array_equal(np.asarray(recon_p), dec_o)


@pytest.mark.parametrize("preset", list(QuantizationLevel))
@pytest.mark.parametrize("pred", ["crossed", "left_top"])
def test_presets_predictors(preset, pred):
    img = _img(61, 94)
    q = quantize_fn(preset)
    grid_o = oracle_encode(img, 4, preset, pred)
    grid_p, _ = encode_plane_planar(img, 4, q, pred)
    assert np.array_equal(np.asarray(grid_p), grid_o)
    dec_o = oracle_decode(grid_o, 4, pred)
    assert np.array_equal(
        np.asarray(decode_plane_planar(grid_o, 4, pred)), dec_o
    )


@pytest.mark.parametrize("preset", list(QuantizationLevel))
def test_tall_plane(preset):
    """A tall, narrow plane: the closed loop carries reconstruction down
    many cell rows, and the canvas pads in both directions."""
    img = _img(300, 52)
    q = quantize_fn(preset)
    for levels in (3, 4):
        grid_o = oracle_encode(img, levels, preset)
        grid_p, _ = encode_plane_planar(img, levels, q)
        assert np.array_equal(np.asarray(grid_p), grid_o), levels
        dec_o = oracle_decode(grid_o, levels)
        dec_p = decode_plane_planar(grid_o, levels)
        assert np.array_equal(np.asarray(dec_p), dec_o), levels


def test_batch_matches_single():
    imgs = np.stack([_img(48, 80) for _ in range(3)])
    q = quantize_fn(QuantizationLevel.MEDIUM)
    grids, recons = encode_plane_planar(imgs, 3, q)
    for k in range(3):
        grid_o = oracle_encode(imgs[k], 3, QuantizationLevel.MEDIUM)
        assert np.array_equal(np.asarray(grids[k]), grid_o)
        assert np.array_equal(
            np.asarray(recons[k]), oracle_decode(grid_o, 3)
        )
    dec = decode_plane_planar(np.asarray(grids), 3)
    for k in range(3):
        assert np.array_equal(
            np.asarray(dec[k]), oracle_decode(np.asarray(grids[k]), 3)
        )


def test_deep_levels_clamped():
    """levels with 2^L > dim clamp exactly like the XLA path."""
    img = _img(24, 40)
    q = quantize_fn(QuantizationLevel.LOSSLESS)
    for levels in (5, 8):
        grid_x, _ = pyramid.encode_plane(img, levels, q)
        grid_p, _ = encode_plane_planar(img, levels, q)
        assert np.array_equal(np.asarray(grid_p), np.asarray(grid_x))


def test_matches_xla_path_lossy():
    """Same bits as ops.pyramid for the closed-loop path."""
    img = _img(90, 110)
    q = quantize_fn(QuantizationLevel.LOW)
    grid_x, recon_x = pyramid.encode_plane(img, 4, q)
    grid_p, recon_p = encode_plane_planar(img, 4, q)
    assert np.array_equal(np.asarray(grid_p), np.asarray(grid_x))
    assert np.array_equal(np.asarray(recon_p), np.asarray(recon_x))


def test_supported_gating():
    q = quantize_fn(QuantizationLevel.MEDIUM)
    assert supported_planar(4, 128, 128, q, "crossed")
    assert supported_planar(4, 128, 128, None, "left_top")
    assert not supported_planar(1, 128, 128, q, "crossed")  # too few levels
    assert not supported_planar(4, 128, 128, q, "line")  # unknown predictor
    assert not supported_planar(4, 128, 128, LUTQuantizer(20), "crossed")
    # NoOp / identity quantizers ride the statically-lossless path.
    assert supported_planar(
        4, 128, 128, quantize_fn(QuantizationLevel.LOSSLESS, "noop"), "crossed"
    )


@pytest.mark.parametrize(
    "engine,levels,quant,batch,want",
    [
        ("auto", 4, "medium", 1, "planar"),
        ("auto", 4, "medium", 8, "xla"),  # batches: dyadic is faster
        ("auto", 1, "medium", 1, "xla"),  # levels < 2: dyadic serves
        ("auto", 4, "lut", 1, "xla"),  # table quantizer: dyadic serves
        ("planar", 4, "medium", 8, "planar"),
        ("xla", 4, "medium", 1, "xla"),
        ("xla", 1, "lut", 1, "xla"),
    ],
)
def test_choose_engine(engine, levels, quant, batch, want):
    q = (
        LUTQuantizer(20) if quant == "lut"
        else quantize_fn(QuantizationLevel.MEDIUM)
    )
    assert choose_engine(engine, levels, 64, 64, q, "crossed", batch) == want


def test_codec_auto_routes_by_batch():
    """HGICodec's auto engine: planar for one plane, dyadic for a batch."""
    from rustyhgi_tpu.models.codec import HGICodec

    c = HGICodec(4, QuantizationLevel.MEDIUM)
    assert c._engine((64, 96), need_quantize=True) == "planar"
    assert c._engine((1, 64, 96), need_quantize=True) == "planar"
    assert c._engine((8, 64, 96), need_quantize=True) == "xla"


def test_choose_engine_refuses():
    q = quantize_fn(QuantizationLevel.MEDIUM)
    with pytest.raises(ValueError, match="does not cover"):
        choose_engine("planar", 1, 64, 64, q, "crossed")
    with pytest.raises(ValueError, match="engine must be one of"):
        choose_engine("pallas", 4, 64, 64, q, "crossed")


def test_tiny_and_edge_shapes():
    q = quantize_fn(QuantizationLevel.MEDIUM)
    for shape in [(4, 4), (5, 9), (16, 4), (4, 17)]:
        img = _img(*shape)
        grid_o = oracle_encode(img, 2, QuantizationLevel.MEDIUM)
        grid_p, _ = encode_plane_planar(img, 2, q)
        assert np.array_equal(np.asarray(grid_p), grid_o), shape
        assert np.array_equal(
            np.asarray(decode_plane_planar(grid_o, 2)),
            oracle_decode(grid_o, 2),
        ), shape


def test_lossless_batches():
    """Lossless batches >= 2 (even, odd, multi-tile) run batch as a grid
    dimension; bit-exact per image vs oracle."""
    q = quantize_fn(QuantizationLevel.LOSSLESS)
    for n in (2, 3, 4):
        imgs = np.stack([_img(44, 60) for _ in range(n)])
        grids, recons = encode_plane_planar(imgs, 3, q)
        for k in range(n):
            grid_o = oracle_encode(imgs[k], 3, QuantizationLevel.LOSSLESS)
            assert np.array_equal(np.asarray(grids[k]), grid_o), (n, k)
            assert np.array_equal(np.asarray(recons[k]), imgs[k]), (n, k)
        dec = decode_plane_planar(np.asarray(grids), 3)
        for k in range(n):
            assert np.array_equal(np.asarray(dec[k]), imgs[k]), (n, k)


def test_batched_left_top_and_deep_levels():
    q = quantize_fn(QuantizationLevel.LOSSLESS)
    imgs = np.stack([_img(40, 48), _img(40, 48)[::-1].copy()])
    for levels, pred in ((2, "left_top"), (6, "crossed")):
        grids, _ = encode_plane_planar(imgs, levels, q, pred)
        for k in range(2):
            grid_o = oracle_encode(
                imgs[k], levels, QuantizationLevel.LOSSLESS, pred
            )
            assert np.array_equal(np.asarray(grids[k]), grid_o), (levels, pred)
        dec = decode_plane_planar(np.asarray(grids), levels, pred)
        for k in range(2):
            assert np.array_equal(np.asarray(dec[k]), imgs[k]), (levels, pred)


def test_codec_batched_planar():
    """[B, H, W] through HGICodec with backend='planar' stays bit-equal
    to per-image oracle encodes."""
    from rustyhgi_tpu.models.codec import HGICodec

    imgs = np.stack([_img(48, 64) for _ in range(4)])
    for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
        c = HGICodec(3, preset, backend="planar")
        grids, recons = c.encode_plane(imgs)
        assert grids.shape == imgs.shape
        for k in range(4):
            grid_o = oracle_encode(imgs[k], 3, preset)
            assert np.array_equal(np.asarray(grids[k]), grid_o), (preset, k)
            assert np.array_equal(
                np.asarray(recons[k]), oracle_decode(grid_o, 3)
            ), (preset, k)
        dec = c.decode_plane(np.asarray(grids))
        assert np.array_equal(np.asarray(dec), np.asarray(recons))


# -- subband emission: bit-exact vs ops.pyramid -------------------------------


def _assert_subbands_equal(res_a, res_b, ctx):
    a1, s1, r1 = res_a
    a2, s2, r2 = res_b
    assert np.array_equal(np.asarray(a1), np.asarray(a2)), ("anchors", ctx)
    assert len(s1) == len(s2), ("levels", ctx)
    for lv, (q1s, q2s) in enumerate(zip(s1, s2)):
        for k, (q1, q2) in enumerate(zip(q1s, q2s)):
            assert np.array_equal(np.asarray(q1), np.asarray(q2)), (
                "quad", lv, k, ctx,
            )
    if r1 is None or r2 is None:
        assert r1 is None and r2 is None, ("recon-none", ctx)
    else:
        assert np.array_equal(np.asarray(r1), np.asarray(r2)), ("recon", ctx)


@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (96, 128)])
@pytest.mark.parametrize("levels", [2, 3, 4, 5])
@pytest.mark.parametrize(
    "preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM]
)
def test_subband_emission_matches_xla(shape, levels, preset):
    img = _img(*shape)
    q = quantize_fn(preset)
    ctx = (shape, levels, preset)
    _assert_subbands_equal(
        pyramid.encode_subbands(img, levels, q),
        encode_subbands_planar(img, levels, q, "crossed"),
        ctx,
    )


@pytest.mark.parametrize(
    "preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM]
)
def test_subband_emission_tall(preset):
    img = _img(300, 52)
    q = quantize_fn(preset)
    _assert_subbands_equal(
        pyramid.encode_subbands(img, 3, q),
        encode_subbands_planar(img, 3, q, "crossed"),
        preset,
    )


def test_subband_emission_batch_and_predictor():
    imgs = np.stack([_img(48, 64) for _ in range(3)])
    q = quantize_fn(QuantizationLevel.LOSSLESS)
    from rustyhgi_tpu.ops.predictors import predictor_fn

    _assert_subbands_equal(
        pyramid.encode_subbands(imgs, 4, q, predictor_fn("left_top")),
        encode_subbands_planar(imgs, 4, q, "left_top"),
        "batch-left_top",
    )


def test_subband_emission_want_recon_false():
    img = _img(61, 83)
    q = quantize_fn(QuantizationLevel.MEDIUM)
    a, s, r = encode_subbands_planar(img, 4, q, "crossed", want_recon=False)
    assert r is None
    a2, s2, _ = pyramid.encode_subbands(img, 4, q)
    _assert_subbands_equal((a, s, None), (a2, s2, None), "no-recon")


def test_codec_encode_subbands_planar_backend_roundtrip():
    """HGICodec.encode_subbands with backend='planar' gives the same
    subband payload as the dyadic engine, and decodes to its recon."""
    from rustyhgi_tpu.models.codec import HGICodec

    img = _img(64, 96)
    c = HGICodec(4, QuantizationLevel.MEDIUM, backend="planar")
    anchors, subbands, recon = c.encode_subbands(img)
    dec = c.decode_subbands(anchors, subbands, img.shape)
    assert np.array_equal(np.asarray(dec), np.asarray(recon))
    c_x = HGICodec(4, QuantizationLevel.MEDIUM, backend="xla")
    a2, s2, r2 = c_x.encode_subbands(img)
    _assert_subbands_equal(
        (anchors, subbands, recon), (a2, s2, r2), "codec-route"
    )


# -- subband-direct decode ----------------------------------------------------


def _assert_sb_decode(shape, levels, preset, pred):
    from rustyhgi_tpu.ops.predictors import predictor_fn

    img = _img(*shape)
    q = quantize_fn(preset)
    a, s, _ = pyramid.encode_subbands(img, levels, q, predictor_fn(pred))
    ref = np.asarray(
        pyramid.decode_subbands(a, s, shape, levels, predictor_fn(pred))
    )
    got = np.asarray(decode_subbands_planar(a, s, shape, levels, pred))
    assert np.array_equal(ref, got), (shape, levels, preset, pred)


@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (130, 68)])
@pytest.mark.parametrize("levels", [2, 3, 4, 5])
@pytest.mark.parametrize(
    "preset", [QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM]
)
def test_subband_decode_matches_xla(shape, levels, preset):
    _assert_sb_decode(shape, levels, preset, "crossed")


@pytest.mark.parametrize("levels", [3, 4])
def test_subband_decode_tall(levels):
    _assert_sb_decode((300, 96), levels, QuantizationLevel.HIGH, "crossed")


def test_subband_decode_left_top_and_batch():
    _assert_sb_decode((96, 64), 4, QuantizationLevel.LOW, "left_top")
    # batch: leading dim through the same program
    imgs = np.stack([_img(48, 64) for _ in range(3)])
    q = quantize_fn(QuantizationLevel.MEDIUM)
    a, s, _ = pyramid.encode_subbands(imgs, 3, q)
    ref = np.asarray(pyramid.decode_subbands(a, s, (48, 64), 3))
    got = np.asarray(decode_subbands_planar(a, s, (48, 64), 3))
    assert np.array_equal(ref, got)


def test_codec_decode_subbands_engines_agree():
    """HGICodec.decode_subbands gives the same image through the planar
    engine and the dyadic engine."""
    from rustyhgi_tpu.models.codec import HGICodec

    img = _img(64, 96)
    c_planar = HGICodec(4, QuantizationLevel.MEDIUM, backend="planar")
    anchors, subbands, recon = c_planar.encode_subbands(img)
    dec_planar = c_planar.decode_subbands(anchors, subbands, img.shape)
    assert np.array_equal(np.asarray(dec_planar), np.asarray(recon))

    c_xla = HGICodec(4, QuantizationLevel.MEDIUM, backend="xla")
    dec_xla = c_xla.decode_subbands(anchors, subbands, img.shape)
    assert np.array_equal(np.asarray(dec_xla), np.asarray(recon))
