"""Multi-device SPMD tests on the 8-device virtual CPU mesh.

The invariants the distributed tier must provide (SURVEY.md §4, invented
for this framework since the reference has none): sharded results are
bit-identical to single-device results, independent of mesh shape, with
deterministic batch order; the psum'd histogram equals the host histogram.
"""

import jax
import numpy as np
import pytest

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.ops.quantizers import QuantizationLevel
from rustyhgi_tpu.parallel.mesh import make_mesh
from rustyhgi_tpu.parallel.sharded import (
    decode_batch_sharded,
    encode_batch_sharded,
    pad_batch,
    tile_plane,
    untile_plane,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, size=(16, 24, 40), dtype=np.uint8)


@pytest.fixture(scope="module")
def golden(batch):
    codec = HGICodec(levels=3, quantization=QuantizationLevel.MEDIUM)
    grids, recons = codec.encode_plane(batch)
    return np.asarray(grids), np.asarray(recons)


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_encode_mesh_shape_invariance(batch, golden, shape):
    mesh = make_mesh(shape)
    grids, recons, hist = encode_batch_sharded(
        batch, 3, QuantizationLevel.MEDIUM, mesh=mesh, with_histogram=True
    )
    assert np.array_equal(np.asarray(grids), golden[0])
    assert np.array_equal(np.asarray(recons), golden[1])
    # psum'd histogram == host histogram of all residual bytes
    want = np.bincount(golden[0].reshape(-1), minlength=256)
    assert np.array_equal(np.asarray(hist), want)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("engine", ["planar", "xla"])
def test_sharded_engine_multi_device(batch, golden, shape, engine):
    """Each engine INSIDE shard_map on a >1-device mesh.

    Bytes must equal the single-device golden (mesh-shape- and
    engine-invariance in one assertion).
    """
    mesh = make_mesh(shape)
    grids, recons, hist = encode_batch_sharded(
        batch, 3, QuantizationLevel.MEDIUM, mesh=mesh, with_histogram=True,
        engine=engine,
    )
    assert np.array_equal(np.asarray(grids), golden[0])
    assert np.array_equal(np.asarray(recons), golden[1])
    want = np.bincount(golden[0].reshape(-1), minlength=256)
    assert np.array_equal(np.asarray(hist), want)
    decoded = decode_batch_sharded(golden[0], 3, mesh=mesh, engine=engine)
    assert np.array_equal(np.asarray(decoded), golden[1])


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("engine", ["planar", "xla"])
def test_sharded_subband_encode_decode(batch, shape, engine):
    """Sharded subband encode -> subband-direct decode, engine-invariant.

    The .thgi subband payload produced on a mesh must match the
    single-device dyadic payload byte-for-byte for every (mesh shape,
    engine) combination, and the subband-direct decode must reconstruct
    the closed-loop recon.
    """
    import jax
    import jax.numpy as jnp

    from rustyhgi_tpu.ops import pyramid
    from rustyhgi_tpu.ops.quantizers import quantize_fn
    from rustyhgi_tpu.parallel.sharded import (
        decode_subbands_batch_sharded,
        encode_subbands_batch_sharded,
    )

    q = quantize_fn(QuantizationLevel.MEDIUM)
    ga, gs, grecon = jax.vmap(
        lambda im: pyramid.encode_subbands(im, 3, q)
    )(jnp.asarray(batch))
    mesh = make_mesh(shape)
    a, s = encode_subbands_batch_sharded(
        batch, 3, QuantizationLevel.MEDIUM, mesh=mesh, engine=engine,
    )
    assert np.array_equal(np.asarray(a), np.asarray(ga))
    for qs1, qs2 in zip(s, gs):
        for x, y in zip(qs1, qs2):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    dec = decode_subbands_batch_sharded(
        a, s, batch.shape[1:], 3, mesh=mesh, engine=engine
    )
    assert np.array_equal(np.asarray(dec), np.asarray(grecon))


def test_sharded_decode_roundtrip(batch, golden):
    mesh = make_mesh((4, 2))
    decoded = decode_batch_sharded(golden[0], 3, mesh=mesh)
    assert np.array_equal(np.asarray(decoded), golden[1])


def test_tile_untile_roundtrip():
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 256, size=(53, 71), dtype=np.uint8)
    tiles, shape = tile_plane(plane, (16, 32))
    assert tiles.shape == (4 * 3, 16, 32)
    assert np.array_equal(untile_plane(tiles, shape), plane)


def test_tiled_sharded_e2e_lossless():
    # Gigapixel-axis slice: tile a plane, encode tiles sharded, decode,
    # reassemble — must be exactly the original (tiles are independent
    # streams, so lossless holds per tile and globally).
    rng = np.random.default_rng(11)
    plane = rng.integers(0, 256, size=(100, 90), dtype=np.uint8)
    tiles, shape = tile_plane(plane, (32, 32))
    padded, n_pad = pad_batch(tiles, 8)
    mesh = make_mesh((8, 1))
    grids, recons, _ = encode_batch_sharded(
        padded, 4, QuantizationLevel.LOSSLESS, mesh=mesh
    )
    decoded = np.asarray(decode_batch_sharded(grids, 4, mesh=mesh))
    n = tiles.shape[0]
    assert np.array_equal(untile_plane(decoded[:n], shape), plane)
    assert np.array_equal(np.asarray(recons)[:n], tiles)


def test_multihost_driver_single_process():
    from rustyhgi_tpu.parallel.multihost import (
        decode_tiled_multihost,
        encode_tiled_multihost,
    )
    from rustyhgi_tpu.utils.container import read_archive

    rng = np.random.default_rng(5)
    plane = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    res = encode_tiled_multihost(
        plane, (32, 32), 3, QuantizationLevel.LOSSLESS, fmt="hgi"
    )
    assert len(res.blocks) == 4
    assert res.dcn_payload_bytes == 0  # single process: nothing crosses DCN
    assert sorted(res.local_indices) == [0, 1, 2, 3]
    tiles = np.stack([read_archive(b).grid for b in res.blocks])
    codec = HGICodec(levels=3)
    decoded = np.asarray(codec.decode_plane(tiles))
    assert np.array_equal(untile_plane(decoded, (64, 64)), plane)
    # the distributed decode driver agrees
    dec = decode_tiled_multihost(res.blocks, res.shape, (32, 32))
    assert np.array_equal(dec, plane)


def test_sharded_calls_are_cached(batch):
    from rustyhgi_tpu.parallel import sharded

    mesh = make_mesh((8, 1))
    before = len(sharded._SHARD_CACHE)
    for _ in range(3):
        encode_batch_sharded(batch, 3, QuantizationLevel.MEDIUM, mesh=mesh)
    added = len(sharded._SHARD_CACHE) - before
    assert added <= 1  # repeated identical calls reuse one compiled fn


def test_histogram_overflow_guard():
    # 2**31-pixel batches must be rejected up front (before any transfer),
    # not silently overflow the int32 counts.  The strided view keeps the
    # huge logical shape lazy on the numpy side.
    huge = np.lib.stride_tricks.as_strided(
        np.zeros(1, np.uint8), shape=(1 << 16, 256, 256), strides=(0, 0, 0)
    )
    with pytest.raises(ValueError, match="2\\*\\*31"):
        encode_batch_sharded(
            huge, 1, QuantizationLevel.LOSSLESS, mesh=make_mesh((8, 1)),
            with_histogram=True,
        )


def test_histogram_none_when_not_requested(batch):
    _, _, hist = encode_batch_sharded(
        batch, 3, QuantizationLevel.MEDIUM, mesh=make_mesh((8, 1))
    )
    assert hist is None
