"""Device bit-plane packing: the legacy ``bitpack`` entropy stage.

Only an explicit ``codecs=["bitpack"]`` request writes this format
(utils.container); readers of stored ``bitpack`` archives need
:func:`unpack_bytes`.  Bit-plane packing is zigzag, shift, mask and
reduce arithmetic, which XLA fuses into a few device loops:

* residual bytes are zigzag-remapped (mod-256 residuals cluster near 0 and
  255; zigzag folds them to small magnitudes),
* the stream is blocked into 1024-symbol blocks of shape (8, 128),
* each block stores only ``b = bits_needed(max zigzag)`` bit-planes, one
  (1, 128) row per plane, where byte ``out[r, j]`` packs bit ``r`` of the
  8 values in column ``j``,
* the device emits a fixed-capacity (8, 128) output per block plus the
  per-block width; the **host finalizer** is two vectorized NumPy mask
  moves (concatenate kept rows / re-expand), no per-byte host work.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "zigzag",
    "unzigzag",
    "pack_blocks",
    "unpack_blocks",
    "finalize_packed",
    "expand_packed",
    "pack_bytes",
    "unpack_bytes",
]

BLOCK = 1024  # symbols per block: an (8, 128) u8 tile
_SUB, _LANE = 8, 128


def zigzag(v: jnp.ndarray) -> jnp.ndarray:
    """Fold mod-256 residual bytes to small magnitudes (int32 in/out).

    0, 255, 1, 254, 2, ... -> 0, 1, 2, 3, 4, ...
    """
    small = v < 128
    return jnp.where(small, v * 2, (256 - v) * 2 - 1)


def unzigzag(z: jnp.ndarray) -> jnp.ndarray:
    even = (z & 1) == 0
    return jnp.where(even, z >> 1, (256 - ((z + 1) >> 1)) & 255)


# Bit k of a plane byte comes from row k of the block.
_ROW_BIT = jnp.arange(_SUB, dtype=jnp.int32)[None, :, None]


@jax.jit
def _pack(blocks):
    z = zigzag(blocks.astype(jnp.int32))  # [nb, 8, 128]
    m = jnp.max(z, axis=(1, 2))
    width = sum((m >= (1 << r)).astype(jnp.int32) for r in range(8))
    planes = [jnp.sum(((z >> r) & 1) << _ROW_BIT, axis=1) for r in range(8)]
    return jnp.stack(planes, axis=1).astype(jnp.uint8), width


@jax.jit
def _unpack(expanded):
    p = expanded.astype(jnp.int32)  # [nb, 8 (planes), 128]
    z = jnp.zeros(p.shape, jnp.int32)
    for r in range(8):
        z = z | (((p[:, r:r + 1, :] >> _ROW_BIT) & 1) << r)
    return unzigzag(z).astype(jnp.uint8)


def pack_blocks(flat: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """Device bit-pack of a flat uint8 stream.

    Returns ``(packed [nb, 8, 128] u8, widths [nb] i32, nb)`` where only
    the first ``widths[i]`` planes of block i carry data.
    """
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    blocks = jnp.pad(flat, (0, nb * BLOCK - n)).reshape(nb, _SUB, _LANE)
    packed, widths = _pack(blocks)
    return packed, widths, nb


def unpack_blocks(expanded: jnp.ndarray) -> jnp.ndarray:
    """Device unpack of host-expanded bitplane blocks -> flat uint8.

    Absent planes are zero-filled by the host expander, so the full
    8-plane reconstruction is exact regardless of block width.
    """
    return _unpack(expanded).reshape(-1)


# -- host finalizer ---------------------------------------------------------


def finalize_packed(
    packed: np.ndarray, widths: np.ndarray, nb: int, n: int
) -> bytes:
    """Frame the device output: keep only the used planes of each block.

    Layout: u32 LE n, u32 LE nb, nb width nibbles (2 per byte, padded),
    then the concatenated kept planes (128 B per plane).
    """
    packed = np.asarray(packed)[:nb]
    widths = np.asarray(widths)[:nb].astype(np.uint8)
    mask = np.arange(_SUB)[None, :] < widths[:, None]
    body = packed[mask]  # [sum(widths), 128] — one vectorized gather
    nib = widths.copy()
    if nib.size % 2:
        nib = np.append(nib, 0)
    nibbles = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    return b"".join(
        (
            int(n).to_bytes(4, "little"),
            int(nb).to_bytes(4, "little"),
            nibbles.tobytes(),
            body.tobytes(),
        )
    )


def expand_packed(data: bytes, expected_n: int = None) -> Tuple[np.ndarray, int]:
    """Inverse of :func:`finalize_packed`: re-expand to fixed-capacity
    blocks (zero-filled absent planes).

    ``expected_n`` (when given) is the caller's header-derived stream
    size: the embedded counts must match it exactly, so a hostile body
    cannot declare its own allocation size (bomb guard).

    Returns (expanded [nb, 8, 128] u8, n).
    """
    if len(data) < 8:
        raise ValueError("truncated bitpack stream")
    n = int.from_bytes(data[0:4], "little")
    nb = int.from_bytes(data[4:8], "little")
    if expected_n is not None and n != expected_n:
        raise ValueError(
            f"bitpack stream size {n} does not match declared {expected_n}"
        )
    if nb != -(-n // BLOCK):
        raise ValueError("bitpack block count does not match stream size")
    nnib = (nb + 1) // 2
    nibbles = np.frombuffer(data, np.uint8, count=nnib, offset=8)
    widths = np.empty(2 * nnib, np.uint8)
    widths[0::2] = nibbles & 0xF
    widths[1::2] = nibbles >> 4
    widths = widths[:nb]
    total_planes = int(widths.sum(dtype=np.int64))
    body = np.frombuffer(
        data, np.uint8, count=total_planes * _LANE, offset=8 + nnib
    ).reshape(total_planes, _LANE)
    expanded = np.zeros((nb, _SUB, _LANE), np.uint8)
    mask = np.arange(_SUB)[None, :] < widths[:, None]
    expanded[mask] = body
    return expanded, n


def pack_bytes(flat_u8) -> bytes:
    """End-to-end helper: device pack + host finalize of a uint8 stream."""
    flat = jnp.asarray(flat_u8, jnp.uint8).reshape(-1)
    if flat.shape[0] == 0:
        return finalize_packed(
            np.zeros((0, _SUB, _LANE), np.uint8), np.zeros(0, np.int32), 0, 0
        )
    packed, widths, nb = pack_blocks(flat)
    return finalize_packed(
        np.asarray(packed), np.asarray(widths), nb, int(flat.shape[0])
    )


def unpack_bytes(data: bytes, expected_n: int = None) -> np.ndarray:
    """Inverse of :func:`pack_bytes` -> uint8 [n] array."""
    expanded, n = expand_packed(data, expected_n=expected_n)
    if n == 0:
        return np.zeros(0, np.uint8)
    flat = unpack_blocks(jnp.asarray(expanded))
    return np.asarray(flat[:n])
