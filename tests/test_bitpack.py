"""Device bit-pack stage (ops.bitpack): round trips and the stored format."""

import hashlib

import numpy as np
import pytest

from rustyhgi_tpu.ops import bitpack as pk


def residual_like(rng, n):
    # Peaked-with-tail distribution resembling zigzagged residuals.
    small = rng.integers(-8, 9, n) % 256
    big = rng.integers(0, 256, n)
    return np.where(rng.random(n) < 0.95, small, big).astype(np.uint8)


def test_zigzag_bijective():
    v = np.arange(256, dtype=np.int32)
    z = np.asarray(pk.zigzag(v))
    assert sorted(z.tolist()) == list(range(256))
    assert np.array_equal(np.asarray(pk.unzigzag(z)), v)
    assert z[0] == 0 and z[255] == 1 and z[1] == 2  # small |residual| -> small


@pytest.mark.parametrize("n", [0, 1, 127, 1024, 5000, 65536])
def test_pack_roundtrip(rng, n):
    data = residual_like(rng, n)
    blob = pk.pack_bytes(data)
    assert np.array_equal(pk.unpack_bytes(blob), data)


def test_pack_bytes_match_stored_format():
    # Bytes written by the earlier device packer for this seeded stream;
    # stored bitpack archives must keep reading, so the format is pinned.
    rng = np.random.default_rng(123)
    small = rng.integers(-8, 9, 5000) % 256
    big = rng.integers(0, 256, 5000)
    data = np.where(rng.random(5000) < 0.9, small, big).astype(np.uint8)
    blob = pk.pack_bytes(data)
    assert len(blob) == 5131
    assert hashlib.sha256(blob).hexdigest() == (
        "bfcec0646208e15d6e44a235aac4151afaf852d2f130dff9712e9710d0867378"
    )
    assert np.array_equal(pk.unpack_bytes(blob, expected_n=5000), data)


def test_pack_compresses_smooth_blocks(rng):
    # Every block's max zigzag < 16 -> 4 planes -> ~2x reduction.
    data = (rng.integers(-4, 5, 64 * 1024) % 256).astype(np.uint8)
    blob = pk.pack_bytes(data)
    assert len(blob) < 0.6 * data.size


def test_pack_bounded_expansion(rng):
    # Worst case (uniform bytes): 8 planes everywhere ~= raw size + framing.
    data = rng.integers(0, 256, 32 * 1024, dtype=np.uint8)
    blob = pk.pack_bytes(data)
    assert len(blob) <= data.size + data.size // 64 + 64


def test_thgi_fast_mode(rng):
    from rustyhgi_tpu.ops.quantizers import QuantizationLevel
    from rustyhgi_tpu.utils.container import (
        Archive,
        Interpolation,
        Metadata,
        read_thgi,
        write_thgi,
    )

    grid = (rng.integers(-5, 6, (40, 56)) % 256).astype(np.uint8)
    meta = Metadata(QuantizationLevel.MEDIUM, Interpolation.CROSSED, 56, 40, 3)
    archive = Archive(meta, grid)
    blob = write_thgi(archive, fast=True)
    back = read_thgi(blob)
    assert np.array_equal(back.grid, grid)
    assert back.metadata == meta
