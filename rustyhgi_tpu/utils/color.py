"""Color (RGB) support: the .thgic multi-plane container.

The reference forces every input to 8-bit luma (reference: src/main.rs:42
``to_luma()``); color is simply out of its scope.  This module extends the
framework to RGB while preserving the codec's contracts per channel:

* **Lossless** planes are stored as ``G, (R-G) & 255, (B-G) & 255`` — a
  reversible green-delta decorrelation (chroma deltas cluster near 0 on
  natural images, compressing far better than raw R/B planes).  Exact:
  ``R = (dR + G) & 255``.  A full RCT (JPEG2000-style) would need 9-bit
  chroma planes, which the 8-bit codec cannot carry losslessly, so the
  wrap-safe green-delta is the strongest transform available.
* **Lossy** planes are stored as raw R, G, B: the per-plane max-error
  bound then holds per channel by construction.  (A delta plane would
  compound two lossy errors: |R' - R| <= 2e.)

Container layout (.thgic):

```
u32  magic 0x7C61_A555
u8   n_planes
u8   transform (0 = identity/RGB, 1 = green-delta)
n_planes x { u64 LE length, archive blob (.thgi or .hgi) }
```

Planes are encoded as one batched (vmapped) device call.
"""

from __future__ import annotations

import struct

import numpy as np

from .imageio import load_image, save_image

__all__ = [
    "THGIC_MAGIC",
    "encode_color",
    "decode_color",
    "load_rgb",
    "save_rgb",
]

THGIC_MAGIC = 0x7C61_A555

_T_IDENTITY = 0
_T_GDELTA = 1


def load_rgb(path: str) -> np.ndarray:
    """Load an image file as uint8 [H, W, 3] RGB."""
    return load_image(path, "RGB")


def save_rgb(path: str, rgb: np.ndarray) -> None:
    save_image(path, rgb, "RGB")


def _forward(rgb_planes: np.ndarray, transform: int) -> np.ndarray:
    if transform == _T_IDENTITY:
        return rgb_planes
    r, g, b = (p.astype(np.int16) for p in rgb_planes)
    return np.stack(
        [g.astype(np.uint8), ((r - g) & 255).astype(np.uint8),
         ((b - g) & 255).astype(np.uint8)]
    )


def _inverse(planes: np.ndarray, transform: int) -> np.ndarray:
    if transform == _T_IDENTITY:
        return planes
    g, dr, db = (p.astype(np.int16) for p in planes)
    return np.stack(
        [((dr + g) & 255).astype(np.uint8), g.astype(np.uint8),
         ((db + g) & 255).astype(np.uint8)]
    )


def _encode_one(codec, rgb_planes: np.ndarray, transform: int, fmt: str) -> bytes:
    from .container import Archive, write_archive

    planes = _forward(rgb_planes, transform)
    grids = np.asarray(codec.encode_plane(planes)[0])
    h, w = rgb_planes.shape[1:]
    parts = [struct.pack("<IBB", THGIC_MAGIC, 3, transform)]
    for grid in grids:
        blob = write_archive(Archive(codec.metadata_for(h, w), grid), fmt)
        parts.append(struct.pack("<Q", len(blob)))
        parts.append(blob)
    return b"".join(parts)


def encode_color(codec, rgb: np.ndarray, fmt: str = "thgi") -> bytes:
    """Encode a uint8 [H, W, 3] RGB image to a .thgic container.

    ``codec`` is an :class:`rustyhgi_tpu.models.codec.HGICodec`; the three
    planes run as one vmapped device encode.  Lossless presets race both
    transforms (green-delta usually wins on natural images, identity on
    channel-independent content) and keep the smaller container; lossy
    presets store raw channels so the per-channel max-error bound is
    exactly the preset's.
    """
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got {rgb.shape}")
    from ..ops.quantizers import linear_error

    planes = np.moveaxis(rgb, 2, 0)
    if linear_error(codec.quantization) != 0:
        return _encode_one(codec, planes, _T_IDENTITY, fmt)
    return min(
        (
            _encode_one(codec, planes, _T_GDELTA, fmt),
            _encode_one(codec, planes, _T_IDENTITY, fmt),
        ),
        key=len,
    )


def _split_thgic(data: bytes):
    if len(data) < 6:
        raise ValueError("truncated archive")
    magic, n_planes, transform = struct.unpack_from("<IBB", data, 0)
    if magic != THGIC_MAGIC:
        raise ValueError("incorrect magic number")
    if n_planes != 3 or transform not in (_T_IDENTITY, _T_GDELTA):
        raise ValueError(
            f"unsupported .thgic: planes={n_planes} transform={transform}"
        )
    off = 6
    blobs = []
    for _ in range(n_planes):
        if off + 8 > len(data):
            raise ValueError("truncated archive")
        (blen,) = struct.unpack_from("<Q", data, off)
        off += 8
        if off + blen > len(data):
            raise ValueError("truncated archive")
        blobs.append(data[off : off + blen])
        off += blen
    return transform, blobs


def decode_color(data: bytes) -> np.ndarray:
    """Decode a .thgic container back to uint8 [H, W, 3] RGB."""
    from .container import read_archive
    from ..models.codec import HGICodec

    transform, blobs = _split_thgic(data)
    archives = [read_archive(b) for b in blobs]
    meta = archives[0].metadata
    codec = HGICodec(meta.scale_level)
    grids = np.stack([a.grid for a in archives])
    planes = np.asarray(codec.decode_plane(grids))
    return np.moveaxis(_inverse(planes, transform), 0, 2)


def decode_color_preview(data: bytes, upto: int) -> np.ndarray:
    """Progressive color decode -> uint8 [h, w, 3] downsampled preview.

    The green-delta transform is per-pixel, so it commutes with lattice
    sampling: per-plane previews invert to exactly the full color
    reconstruction sampled at the preview lattice.
    """
    from .container import read_preview
    from ..models.codec import HGICodec

    transform, blobs = _split_thgic(data)
    planes = []
    for blob in blobs:
        meta, anchors, subbands, eff = read_preview(blob, upto)
        codec = HGICodec(meta.scale_level)
        planes.append(
            np.asarray(
                codec.decode_preview(
                    anchors, subbands, (meta.height, meta.width), eff
                )
            )
        )
    return np.moveaxis(_inverse(np.stack(planes), transform), 0, 2)
