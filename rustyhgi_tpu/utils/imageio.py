"""Host-side image I/O.

The reference loads images with the ``image`` crate and converts to 8-bit
luma via ``to_luma()`` (reference: src/main.rs:42,74).  Binary netpbm
files (``.pgm`` gray, ``.ppm`` RGB, 8-bit) are read and written with
numpy alone, so the codec's main path needs no imaging library; every
other format goes through Pillow.  For inputs that are already 8-bit
grayscale (e.g. res/LENA.TIF, mode L) the luma conversion is the
identity, which is why cross-tool bit-exact comparisons anchor on such
inputs (SURVEY.md §6).  For RGB inputs the BT.601 luma weights of the two
libraries may differ by ±1 per pixel in rounding; lossy-mode comparisons
are therefore judged on max-error bound and compressed size, not pixel
identity.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["load_luma", "save_gray", "load_image", "save_image"]

# Binary netpbm magic per extension: P5 = gray, P6 = RGB.
_PNM = {".pgm": b"P5", ".ppm": b"P6"}


def _pnm_magic(path: str):
    return _PNM.get(os.path.splitext(path)[1].lower())


def _read_pnm(path: str, magic: bytes) -> np.ndarray:
    """Parse an 8-bit binary netpbm file -> uint8 [H, W] or [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # comment to end of line
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated netpbm header")
        fields.append(data[start:pos])
    if fields[0] != magic:
        raise ValueError(f"{path}: expected a binary {magic.decode()} file")
    try:
        w, h, maxval = (int(x) for x in fields[1:])
    except ValueError:
        raise ValueError(f"{path}: malformed netpbm header") from None
    if maxval != 255:
        raise ValueError(f"{path}: only 8-bit netpbm (maxval 255) is supported")
    channels = 1 if magic == b"P5" else 3
    body = data[pos + 1:]  # exactly one whitespace byte ends the header
    if w <= 0 or h <= 0 or len(body) < w * h * channels:
        raise ValueError(f"{path}: truncated netpbm pixel data")
    pixels = np.frombuffer(body, np.uint8, count=w * h * channels)
    return pixels.reshape((h, w) if channels == 1 else (h, w, 3)).copy()


def _write_pnm(path: str, pixels: np.ndarray, magic: bytes) -> None:
    h, w = pixels.shape[:2]
    with open(path, "wb") as f:
        f.write(b"%s\n%d %d\n255\n" % (magic, w, h))
        f.write(np.ascontiguousarray(pixels, np.uint8).tobytes())


def _pillow():
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            "this image format needs Pillow; use .pgm/.ppm files or "
            "install Pillow"
        ) from None
    return Image


def load_image(path: str, mode: str) -> np.ndarray:
    """Load an image as uint8 [H, W] (``mode="L"``) or [H, W, 3] ("RGB")."""
    magic = _pnm_magic(path)
    if magic is not None:
        if magic != {"L": b"P5", "RGB": b"P6"}[mode]:
            raise ValueError(f"{path}: a {mode} image needs the "
                             f"{'.pgm' if mode == 'L' else '.ppm'} format")
        return _read_pnm(path, magic)
    with _pillow().open(path) as im:
        return np.asarray(im.convert(mode), dtype=np.uint8)


def save_image(path: str, pixels: np.ndarray, mode: str) -> None:
    """Save uint8 [H, W] ("L") or [H, W, 3] ("RGB"); format by extension."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    magic = _pnm_magic(path)
    if magic is not None:
        if magic != {"L": b"P5", "RGB": b"P6"}[mode]:
            raise ValueError(f"{path}: a {mode} image needs the "
                             f"{'.pgm' if mode == 'L' else '.ppm'} format")
        _write_pnm(path, pixels, magic)
        return
    _pillow().fromarray(pixels, mode=mode).save(path)


def load_luma(path: str) -> np.ndarray:
    """Load an image file as a uint8 [H, W] luma plane."""
    return load_image(path, "L")


def save_gray(path: str, plane: np.ndarray) -> None:
    """Save a uint8 [H, W] plane as a grayscale image (format by extension)."""
    save_image(path, plane, "L")
