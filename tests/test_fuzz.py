"""Seeded fuzz: random configs, device codec vs scalar oracle, bit-exact.

Broad randomized sweep over shapes x levels x presets x predictors —
the cheap insurance layer on top of the parametrized golden tests.
"""

import numpy as np
import pytest

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.ops.quantizers import QuantizationLevel, linear_error
from rustyhgi_tpu.oracle import oracle_decode, oracle_encode

PREDICTORS = ["crossed", "crossed", "crossed", "left_top"]


@pytest.mark.parametrize("trial", range(24))
def test_fuzz_roundtrip_vs_oracle(trial):
    rng = np.random.default_rng(1000 + trial)
    h = int(rng.integers(1, 70))
    w = int(rng.integers(1, 70))
    levels = int(rng.integers(0, 7))
    quant = QuantizationLevel(int(rng.integers(0, 4)))
    predictor = PREDICTORS[int(rng.integers(0, len(PREDICTORS)))]
    # Mix of smooth, noisy, and extreme-contrast content.
    kind = int(rng.integers(0, 3))
    if kind == 0:
        image = rng.integers(0, 256, (h, w), dtype=np.uint8)
    elif kind == 1:
        image = (np.add.outer(np.arange(h), np.arange(w)) & 0xFF).astype(np.uint8)
    else:
        image = rng.choice([0, 255], size=(h, w)).astype(np.uint8)

    codec = HGICodec(levels, quant, predictor=predictor)
    grid, recon = codec.encode_plane(image)
    want = oracle_encode(image, levels, quant, predictor)
    ctx = (trial, h, w, levels, int(quant), predictor, kind)
    assert np.array_equal(np.asarray(grid), want), ctx
    decoded = np.asarray(codec.decode_plane(grid))
    assert np.array_equal(decoded, oracle_decode(want, levels, predictor)), ctx
    assert np.array_equal(np.asarray(recon), decoded), ctx
    err = np.abs(image.astype(np.int32) - decoded.astype(np.int32))
    assert err.max() <= linear_error(quant), ctx

    # Planar engine (the auto route; on CPU it compiles the same XLA
    # program the GPU runs) — same trial must be bit-identical too.
    from rustyhgi_tpu.ops import planar
    from rustyhgi_tpu.ops.quantizers import quantize_fn

    if planar.supported_planar(levels, h, w, quantize_fn(quant), predictor):
        g2, r2 = planar.encode_plane_planar(
            image, levels, quantize_fn(quant), predictor
        )
        assert np.array_equal(np.asarray(g2), want), ctx
        d2 = planar.decode_plane_planar(want, levels, predictor)
        assert np.array_equal(np.asarray(d2), decoded), ctx
