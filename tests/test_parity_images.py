"""Cross-backend parity on real photographic content.

Random planes exercise the math uniformly; real photos exercise realistic
residual statistics (smooth gradients, edges, texture).  The JAX device
path and the scalar C++ twin must agree bit-for-bit on both.
"""

import numpy as np
import pytest

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.ops.native import available, native_decode, native_encode
from rustyhgi_tpu.ops.quantizers import QuantizationLevel

needs_native = pytest.mark.skipif(
    not available(), reason="native library not built"
)

@pytest.fixture(scope="module")
def fullhd():
    from conftest import reference_image

    return reference_image("fullhd.jpg")


@needs_native
@pytest.mark.parametrize("quant", list(QuantizationLevel))
def test_fullhd_jax_matches_native(fullhd, quant):
    codec = HGICodec(4, quant)
    grid, recon = codec.encode_plane(fullhd)
    want = native_encode(fullhd, 4, quant)
    assert np.array_equal(np.asarray(grid), want)
    assert np.array_equal(
        np.asarray(codec.decode_plane(grid)), native_decode(want, 4)
    )
    assert np.array_equal(np.asarray(recon), native_decode(want, 4))


@needs_native
def test_fullhd_container_roundtrip(fullhd):
    from rustyhgi_tpu.utils.container import read_archive, write_thgi

    codec = HGICodec(4, "high")
    archive = codec.encode(fullhd)
    back = read_archive(write_thgi(archive))
    decoded = codec.decode(back)
    err = np.abs(fullhd.astype(np.int32) - decoded.astype(np.int32))
    assert err.max() <= 30
