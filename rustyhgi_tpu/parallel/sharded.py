"""SPMD batched/tiled encode over a device mesh.

Replaces the reference's single-threaded drive loop (there is none to port —
SURVEY.md §2) with ``shard_map`` data parallelism: a [B, H, W] batch of
image planes is sharded over the (data, tile) mesh, every device runs the
dense lattice-pyramid kernel on its local shard, and (opt-in) a ``psum``
over the mesh produces the global residual-byte histogram that
parameterizes shared rANS entropy tables (BASELINE.json: "broadcasting
shared quantization tables and coder models").  Compressed blocks are
gathered on host in deterministic batch order.

Tiling (the gigapixel axis): ``tile_plane``/``untile_plane`` split an
arbitrarily large plane into fixed-size tiles that are *independent* HGI
streams — no halo exchange, matching the multi-host plan of SURVEY.md §5.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import planar, pyramid
from ..ops.engine import choose_engine
from ..ops.quantizers import QuantizationLevel, quantize_fn
from .mesh import DATA_AXIS, TILE_AXIS, make_mesh

__all__ = [
    "encode_batch_sharded",
    "decode_batch_sharded",
    "encode_subbands_batch_sharded",
    "decode_subbands_batch_sharded",
    "tile_plane",
    "untile_plane",
    "sharded_histogram",
]


def _batch_pspec() -> P:
    # Batch axis split over both mesh axes; H, W replicated (unsharded).
    return P((DATA_AXIS, TILE_AXIS))


def _mesh_key(mesh: Mesh):
    return (
        mesh.axis_names,
        tuple(mesh.shape.values()),
        tuple(d.id for d in mesh.devices.flat),
    )


# Compiled shard_map executables, keyed by (kind, mesh, shape, params).
# Rebuilding jit(shard_map(...)) per call would re-trace and re-compile
# every time (~seconds); cached calls are pure dispatch.  Bounded FIFO so
# services cycling through many distinct batch shapes cannot grow it
# without limit (compiled executables are MBs each).
_SHARD_CACHE = {}
_SHARD_CACHE_MAX = 64


def _local_batch(planes, mesh: Mesh) -> int:
    """Planes each device processes: the engine policy's batch size."""
    return max(1, planes.shape[0] // mesh.devices.size)


def _cache_put(key, fn):
    if len(_SHARD_CACHE) >= _SHARD_CACHE_MAX:
        _SHARD_CACHE.pop(next(iter(_SHARD_CACHE)))
    _SHARD_CACHE[key] = fn
    return fn


def encode_batch_sharded(
    images,
    levels: int,
    quantization: QuantizationLevel,
    mesh: Optional[Mesh] = None,
    with_histogram: bool = False,
    predictor: str = "crossed",
    engine: str = "auto",
):
    """Encode a [B, H, W] uint8 batch sharded over the mesh.

    Returns ``(grids, recons, histogram)`` where grids/recons are sharded
    [B, H, W] uint8 arrays (batch order preserved — the gather back to host
    is deterministic because the sharding itself is an ordered partition of
    the batch axis).  With ``with_histogram=True``, ``histogram`` is the
    replicated int32[256] count of residual bytes across the *global*
    batch (psum over both mesh axes), the input for shared entropy-coder
    tables (``rans_encode(..., freqs=normalized_freqs(hist))``); it costs
    a device scatter-add per call, so it is opt-in and ``histogram`` is
    None when not requested.  int32 counts bound
    one call at < 2**31 residual bytes (~2 gigapixels); chunk larger
    batches across calls.

    B must be divisible by the mesh size; callers pad with zero planes and
    drop them after (see :func:`tile_plane` which returns the pad count).
    """
    if mesh is None:
        mesh = make_mesh()
    if with_histogram and int(np.prod(images.shape)) >= 1 << 31:
        # Checked before any device transfer/materialization.
        raise ValueError(
            "histogram counts are int32: chunk batches below 2**31 pixels"
        )
    images = jnp.asarray(images, jnp.uint8)
    spec = _batch_pspec()
    quant = quantize_fn(quantization)
    h, w = images.shape[-2:]
    # Resolve the engine BEFORE the cache key: "auto" and an explicit
    # override resolving to the same engine share one executable.
    engine = choose_engine(
        engine, levels, h, w, quant, predictor,
        batch=_local_batch(images, mesh),
    )
    key = (
        "enc", _mesh_key(mesh), images.shape,
        levels, int(quantization), with_histogram, predictor, engine,
    )
    fn = _SHARD_CACHE.get(key)
    if fn is None:
        from ..ops.predictors import predictor_fn

        pred = predictor_fn(predictor)

        def local_encode(imgs):
            if engine == "planar":
                grids, recons = planar.encode_plane_planar(
                    imgs, levels, quant, predictor
                )
            else:
                grids, recons = jax.vmap(
                    lambda im: pyramid.encode_plane(im, levels, quant, pred)
                )(imgs)
            if with_histogram:
                # Device-side residual histogram; summed over the whole
                # mesh so every device sees the same coder table input.
                hist = jnp.zeros((256,), jnp.int32).at[grids.reshape(-1)].add(1)
                hist = jax.lax.psum(hist, (DATA_AXIS, TILE_AXIS))
            else:
                hist = jnp.zeros((256,), jnp.int32)
            return grids, recons, hist

        fn = jax.jit(
            jax.shard_map(
                local_encode,
                mesh=mesh,
                in_specs=(spec,),
                out_specs=(spec, spec, P()),
            )
        )
        _cache_put(key, fn)
    images = jax.device_put(images, NamedSharding(mesh, spec))
    grids, recons, hist = fn(images)
    # None (not a zeros array) when the histogram was not requested, so a
    # caller that forgot with_histogram=True fails loudly instead of
    # silently building a degenerate coder table.
    return grids, recons, (hist if with_histogram else None)


def decode_batch_sharded(
    grids,
    levels: int,
    mesh: Optional[Mesh] = None,
    predictor: str = "crossed",
    engine: str = "auto",
):
    """Decode a [B, H, W] uint8 residual-grid batch sharded over the mesh."""
    if mesh is None:
        mesh = make_mesh()
    grids = jnp.asarray(grids, jnp.uint8)
    spec = _batch_pspec()
    h, w = grids.shape[-2:]
    engine = choose_engine(
        engine, levels, h, w, None, predictor,
        batch=_local_batch(grids, mesh),
    )
    key = ("dec", _mesh_key(mesh), grids.shape, levels, predictor, engine)
    fn = _SHARD_CACHE.get(key)
    if fn is None:
        from ..ops.predictors import predictor_fn

        pred = predictor_fn(predictor)

        def local_decode(gs):
            if engine == "planar":
                return planar.decode_plane_planar(gs, levels, predictor)
            return jax.vmap(
                lambda g: pyramid.decode_plane(g, levels, pred)
            )(gs)

        fn = jax.jit(
            jax.shard_map(
                local_decode, mesh=mesh, in_specs=(spec,), out_specs=spec,
            )
        )
        _cache_put(key, fn)
    grids = jax.device_put(grids, NamedSharding(mesh, spec))
    return fn(grids)


def encode_subbands_batch_sharded(
    images,
    levels: int,
    quantization: QuantizationLevel,
    mesh: Optional[Mesh] = None,
    predictor: str = "crossed",
    engine: str = "auto",
):
    """Subband-layout encode of a [B, H, W] batch sharded over the mesh.

    Returns ``(anchors, subbands)`` with a leading batch dim on every
    array — the archivable .thgi subband payload, produced without the
    row-major grid interleave (the fastest complete encode, see
    ops.pyramid.encode_subbands).  Like :func:`encode_batch_sharded`,
    bytes are mesh-shape- and engine-invariant.
    """
    if mesh is None:
        mesh = make_mesh()
    images = jnp.asarray(images, jnp.uint8)
    spec = _batch_pspec()
    quant = quantize_fn(quantization)
    h, w = images.shape[-2:]
    engine = choose_engine(
        engine, levels, h, w, quant, predictor,
        batch=_local_batch(images, mesh),
    )
    key = (
        "encsb", _mesh_key(mesh), images.shape,
        levels, int(quantization), predictor, engine,
    )
    fn = _SHARD_CACHE.get(key)
    if fn is None:
        from ..ops.predictors import predictor_fn

        pred = predictor_fn(predictor)

        def local(imgs):
            if engine == "planar":
                anchors, subbands, _ = planar.encode_subbands_planar(
                    imgs, levels, quant, predictor, want_recon=False
                )
            else:
                anchors, subbands, _ = jax.vmap(
                    lambda im: pyramid.encode_subbands(
                        im, levels, quant, pred, want_recon=False
                    )
                )(imgs)
            return anchors, [tuple(q) for q in subbands]

        fn = jax.jit(
            jax.shard_map(
                local, mesh=mesh, in_specs=(spec,), out_specs=spec,
            )
        )
        _cache_put(key, fn)
    images = jax.device_put(images, NamedSharding(mesh, spec))
    return fn(images)


def decode_subbands_batch_sharded(
    anchors,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    mesh: Optional[Mesh] = None,
    predictor: str = "crossed",
    engine: str = "auto",
):
    """Subband-direct decode of a sharded batch: -> [B, H, W] planes.

    Engine per :func:`rustyhgi_tpu.ops.engine.choose_engine`.
    """
    if mesh is None:
        mesh = make_mesh()
    anchors = jnp.asarray(anchors, jnp.uint8)
    subbands = [tuple(jnp.asarray(q, jnp.uint8) for q in qs) for qs in subbands]
    spec = _batch_pspec()
    h, w = tuple(shape)[-2:]
    engine = choose_engine(
        engine, levels, h, w, None, predictor,
        batch=_local_batch(anchors, mesh),
    )
    key = (
        "decsb", _mesh_key(mesh), anchors.shape, tuple(shape),
        levels, predictor, engine,
    )
    fn = _SHARD_CACHE.get(key)
    if fn is None:
        from ..ops.predictors import predictor_fn

        pred = predictor_fn(predictor)

        def local(a, s):
            if engine == "planar":
                return planar.decode_subbands_planar(
                    a, s, (h, w), levels, predictor
                )
            return jax.vmap(
                lambda a1, s1: pyramid.decode_subbands(
                    a1, s1, (h, w), levels, pred
                )
            )(a, s)

        fn = jax.jit(
            jax.shard_map(
                local, mesh=mesh, in_specs=(spec, spec), out_specs=spec,
            )
        )
        _cache_put(key, fn)
    put = lambda x: jax.device_put(x, NamedSharding(mesh, spec))
    anchors = put(anchors)
    subbands = jax.tree.map(put, subbands)
    return fn(anchors, subbands)


def sharded_histogram(grids, mesh: Optional[Mesh] = None) -> jax.Array:
    """Replicated int32[256] histogram of a sharded uint8 batch."""
    if mesh is None:
        mesh = make_mesh()
    grids = jnp.asarray(grids, jnp.uint8)
    key = ("hist", _mesh_key(mesh), grids.shape)
    fn = _SHARD_CACHE.get(key)
    if fn is None:

        def local(gs):
            h = jnp.zeros((256,), jnp.int32).at[gs.reshape(-1)].add(1)
            return jax.lax.psum(h, (DATA_AXIS, TILE_AXIS))

        fn = jax.jit(
            jax.shard_map(
                local, mesh=mesh, in_specs=(_batch_pspec(),), out_specs=P()
            )
        )
        _cache_put(key, fn)
    return fn(grids)


# --------------------------------------------------------------------------
# Spatial tiling: gigapixel planes -> independent fixed-size tile streams.
# --------------------------------------------------------------------------


def tile_plane(
    plane: np.ndarray, tile: Tuple[int, int]
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Split an [H, W] plane into [nT, th, tw] zero-padded tiles.

    Tiles are row-major over the tile grid — the deterministic stream order
    for gather/reassembly.  Returns (tiles, (H, W)) so ``untile_plane`` can
    crop the padding back off.
    """
    th, tw = tile
    h, w = plane.shape
    nh, nw = -(-h // th), -(-w // tw)
    padded = np.zeros((nh * th, nw * tw), dtype=np.uint8)
    padded[:h, :w] = plane
    tiles = (
        padded.reshape(nh, th, nw, tw).transpose(0, 2, 1, 3).reshape(-1, th, tw)
    )
    return np.ascontiguousarray(tiles), (h, w)


def untile_plane(
    tiles: np.ndarray, shape: Tuple[int, int]
) -> np.ndarray:
    """Inverse of :func:`tile_plane`."""
    h, w = shape
    n, th, tw = tiles.shape
    nh, nw = -(-h // th), -(-w // tw)
    if n != nh * nw:
        raise ValueError(f"{n} tiles cannot cover {shape} with {th}x{tw}")
    padded = (
        tiles.reshape(nh, nw, th, tw).transpose(0, 2, 1, 3).reshape(nh * th, nw * tw)
    )
    return np.ascontiguousarray(padded[:h, :w])


def pad_batch(batch: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Zero-pad the batch axis to a device-count multiple; returns pad count."""
    b = batch.shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return batch, 0
    pad = np.zeros((target - b, *batch.shape[1:]), dtype=batch.dtype)
    return np.concatenate([batch, pad], axis=0), target - b
