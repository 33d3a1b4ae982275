"""Dyadic lattice-pyramid codec engine (pure JAX/XLA).

This module re-designs the reference's scalar per-pixel sweep
(reference: src/encoder.rs:39-71, src/decoder.rs:18-46, src/utils.rs:12-41)
as dense lattice arithmetic, exploiting two structural facts proved in
SURVEY.md §3.5:

1. **No intra-level dependency** — a refinement-level pixel reads only the
   4 corners of its enclosing cell, all written at strictly earlier levels,
   so each level is one embarrassingly-parallel pass.
2. **Position-independent prediction** — the Crossed predictor
   (interpolator.rs:57-91) depends only on the cell corners, not on where
   the pixel sits inside the cell.  All three refined pixels of a cell
   share one prediction.

**Dyadic layout.**  The naive vectorization (strided slices
``img[::s, ::s]`` + 2x upsamples per level) is correct; this module
instead expresses every dyadic move with reshapes and bitcasts, which
were cheap on the hardware it was first built for (whether they still
pay on the GPU is an open question, see PERF.md):

* downsample-by-2: ``reshape(h/2, 2, w)`` + minor-dim slice (no strides);
* split a fine lattice into its 4 parity quads: bitcast byte pairs to
  uint16 (lane axis) + reshape/slice (sublane axis);
* interleave 4 quads back: uint16 repack (lane) + stack/reshape (sublane).

The image is zero-padded to a canvas that is a multiple of 2^levels so all
reshapes stay even.  Padded pixels are forced to reconstruct to exactly 0
each level, which makes in-canvas corner reads of padded positions agree
bit-for-bit with the reference's out-of-bounds-reads-0 rule
(interpolator.rs:75-82); the canvas is cropped off the outputs.

Per level, the entire computation is: packed cell prediction (pad + 4
unit-shifted views + the integer rounding tree of interpolator.rs:41-55),
packed residual/quantize/overflow-fixup (encoder.rs:53-60), and one quad
interleave.  No gathers, no scatters, no strided memory ops; total element
work across levels is ~(4/3)*H*W, matching the reference's single-visit
total.  Only the ``levels <= 8`` level passes are sequential; the Python
loop over them is unrolled at trace time (static shapes per level).

All arithmetic runs in int32 (VPU-native); values stay within [0, 1020] so
integer math is exact, and ``& 255`` reproduces the reference's u8
wrapping semantics (encoder.rs:53,63).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..dyadic import cdiv as _cdiv, effective_levels
from .predictors import cell_prediction_crossed

__all__ = [
    "cell_prediction",
    "encode_plane",
    "decode_plane",
    "decode_preview",
    "reconstruct_encode",
]

_U8 = jnp.uint8
_U16 = jnp.uint16
_I32 = jnp.int32


def _is_identity(quantize) -> bool:
    """True when the quantizer is statically known to be the identity.

    Drives the lossless fast path (skip quantize + overflow fixup; recon
    == source).  Quantizers opt out via ``identity = False`` even when
    their error bound is 0 (the LUT quantizer benches the table-gather
    cost, so it must run through the closed loop).
    """
    ident = getattr(quantize, "identity", None)
    if ident is not None:
        return bool(ident)
    return getattr(quantize, "error", None) == 0


def cell_prediction(coarse: jnp.ndarray) -> jnp.ndarray:
    """Crossed prediction for every cell of a packed coarse lattice.

    See :func:`rustyhgi_tpu.ops.predictors.cell_prediction_crossed` for the
    exact integer rounding-tree semantics (interpolator.rs:41-55) and the
    OOB-reads-0 rule (interpolator.rs:75-82).
    """
    return cell_prediction_crossed(coarse)


# -- dyadic data movement (reshape/bitcast only — no strided slices) -------


def _split4(
    x: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Split uint8 [..., h, w] into parity quads (q00, q01, q10, q11).

    ``qRC[i, j] == x[2i + R, 2j + C]``.  Lane-axis parity is separated by
    bitcasting byte pairs to uint16 (LSB = even column), sublane parity by
    an even reshape + minor-dim slice.
    """
    *lead, h, w = x.shape
    v = lax.bitcast_convert_type(x.reshape(*lead, h, w // 2, 2), _U16)
    even_c = (v & _U16(0xFF)).astype(_U8)
    odd_c = (v >> _U16(8)).astype(_U8)

    def rows(y: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        r = y.reshape(*lead, h // 2, 2, w // 2)
        return r[..., 0, :], r[..., 1, :]

    e0, e1 = rows(even_c)
    o0, o1 = rows(odd_c)
    return e0, o0, e1, o1


def _interleave_lane(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """uint8 [..., h, w] pair -> [..., h, 2w], a in even columns."""
    v = a.astype(_U16) | (b.astype(_U16) << _U16(8))
    u = lax.bitcast_convert_type(v, _U8)  # [..., h, w, 2] LSB-first
    *lead, h, w, _ = u.shape
    return u.reshape(*lead, h, 2 * w)


def _interleave4(
    q00: jnp.ndarray, q01: jnp.ndarray, q10: jnp.ndarray, q11: jnp.ndarray
) -> jnp.ndarray:
    """Inverse of :func:`_split4`: quads [..., h, w] -> uint8 [..., 2h, 2w]."""
    even_rows = _interleave_lane(q00, q01)
    odd_rows = _interleave_lane(q10, q11)
    *lead, h, w2 = even_rows.shape
    return jnp.stack([even_rows, odd_rows], axis=-2).reshape(*lead, 2 * h, w2)


def _pad_canvas(x: jnp.ndarray, levels: int) -> jnp.ndarray:
    """Zero-pad the last two dims up to multiples of 2**levels."""
    *lead, h, w = x.shape
    step = 1 << levels
    hp, wp = _cdiv(h, step) * step, _cdiv(w, step) * step
    if (hp, wp) == (h, w):
        return x
    pad = [(0, 0)] * len(lead) + [(0, hp - h), (0, wp - w)]
    return jnp.pad(x, pad)


def _quad_masks(
    hc: int,
    wc: int,
    s1: int,
    h: int,
    w: int,
    hp: int,
    wp: int,
):
    """In-bounds masks for the three refined quads of one level.

    Quad q01 sits at image coords (2i*s1, (2j+1)*s1), q10 at
    ((2i+1)*s1, 2j*s1), q11 at ((2i+1)*s1, (2j+1)*s1).  True where the
    position is inside the real [h, w] image; padded-canvas positions are
    forced to reconstruct to 0 (the reference's OOB-reads-0 contract).

    Statically specialized: axes where the canvas equals the image need no
    condition; when neither axis pads, returns (None, None, None) and
    callers skip masking entirely.
    """
    if h == hp and w == wp:
        return None, None, None
    true = jnp.full((hc, wc), True)
    if h == hp:
        row_e = row_o = true
    else:
        iy = lax.broadcasted_iota(_I32, (hc, wc), 0)
        row_e = 2 * iy * s1 < h
        row_o = (2 * iy + 1) * s1 < h
    if w == wp:
        col_e = col_o = true
    else:
        ix = lax.broadcasted_iota(_I32, (hc, wc), 1)
        col_e = 2 * ix * s1 < w
        col_o = (2 * ix + 1) * s1 < w
    return row_e & col_o, row_o & col_e, row_o & col_o


def _quad_pyramid(plane: jnp.ndarray, levels: int):
    """One-pass dyadic decomposition of a canvas plane.

    Returns ``(anchors, quads, lattices)`` where ``quads[k]`` holds the
    (q01, q10, q11) parity quads of the lattice with spacing 2**k —
    exactly the positions refined by the level whose fine spacing is
    2**k — ``anchors`` is the 2**levels-spaced lattice, and
    ``lattices[k]`` is the full source lattice at spacing 2**k
    (``lattices[0]`` is the canvas itself, ``lattices[levels]`` the
    anchors).  The pyramid, the per-level quad splits, and the source
    lattices are the same computation, done once.
    """
    quads = []
    lattices = [plane]
    t = plane
    for _ in range(levels):
        t, q01, q10, q11 = _split4(t)
        quads.append((q01, q10, q11))
        lattices.append(t)
    return t, quads, lattices


def encode_plane(
    image: jnp.ndarray,
    levels: int,
    quantize: Callable[[jnp.ndarray], jnp.ndarray],
    predictor: Callable[[jnp.ndarray], jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Encode a uint8 [H, W] plane.

    Returns ``(grid, recon)`` — the residual grid (anchors raw at the
    2**levels lattice, quantized residuals elsewhere; encoder.rs:26-37,62)
    and the reconstructed image, both uint8 [H, W].  Returning the
    reconstruction is free (it is the loop carry) and gives callers
    encoder-side distortion metrics without a decode pass.

    This is :func:`encode_subbands` plus the row-major grid assembly that
    .hgi interop needs; encode-only pipelines use the subband form
    directly.
    """
    h, w = image.shape[-2:]
    anchors, subbands, recon = encode_subbands(image, levels, quantize, predictor)
    return assemble_grid(anchors, subbands, (h, w)), recon


def decode_plane(
    grid: jnp.ndarray,
    levels: int,
    predictor: Callable[[jnp.ndarray], jnp.ndarray] = None,
) -> jnp.ndarray:
    """Decode a uint8 [H, W] residual grid back to the image (decoder.rs:18-46).

    :func:`split_grid` plus :func:`decode_subbands`; subband-layout
    archives skip the split entirely.
    """
    h, w = grid.shape[-2:]
    anchors, subbands = split_grid(grid, levels)
    return decode_subbands(anchors, subbands, (h, w), levels, predictor)


def reconstruct_encode(
    image: jnp.ndarray,
    levels: int,
    quantize: Callable[[jnp.ndarray], jnp.ndarray],
    predictor: Callable[[jnp.ndarray], jnp.ndarray] = None,
) -> jnp.ndarray:
    """Encode and return only the residual grid (see :func:`encode_plane`)."""
    return encode_plane(image, levels, quantize, predictor)[0]


# -- subband layout: the kernel's natural output, no grid assembly ---------


def encode_subbands(
    image: jnp.ndarray,
    levels: int,
    quantize: Callable[[jnp.ndarray], jnp.ndarray],
    predictor: Callable[[jnp.ndarray], jnp.ndarray] = None,
    want_recon: bool = True,
):
    """Encode to subband layout: ``(anchors, subbands, recon)``.

    ``anchors`` is the raw 2**levels lattice; ``subbands[l]`` holds the
    (q01, q10, q11) residual quads of level ``l`` (coarsest first), i.e.
    the packed lattices the device kernel produces anyway — the full-plane
    grid interleave of :func:`encode_plane` is skipped entirely.  The
    residual *values* are identical to the grid's, only the layout differs
    (a wavelet-style subband decomposition); :func:`assemble_grid` converts
    to the row-major plane when .hgi interop is needed.

    Subband shapes are canvas shapes (padded to the 2**levels canvas);
    container code stores them whole and decode crops at the end.

    ``want_recon=False`` skips the final level's reconstruction interleave
    (needed only for the recon output, not for any prediction) and returns
    recon=None — the fastest pure-encode path (~30% less relayout work).

    Lossless (error==0) takes a structurally different path: since the
    reconstruction equals the source exactly, every level predicts from
    the pyramid's own source lattice and the recon interleave chain
    disappears entirely.  The emitted residuals are bit-identical to the
    closed-loop form.
    """
    if predictor is None:
        predictor = cell_prediction
    h, w = image.shape[-2:]
    levels = effective_levels(levels, h, w)
    image = _pad_canvas(image.astype(_U8), levels)
    hp, wp = image.shape[-2:]
    if levels == 0:
        return image, [], (image[..., :h, :w] if want_recon else None)

    lossless = _is_identity(quantize)
    coarse, quads, lattices = _quad_pyramid(image, levels)
    anchors = coarse
    if lossless:
        # Lossless fast path: reconstruction is exactly the source, so the
        # coarser lattice each level predicts from is the pyramid's own
        # source lattice — already computed by _quad_pyramid.  Skipping
        # the recon interleave chain removes the whole closed-loop
        # dependency chain (XLA fuses much more).
        subbands = []
        for level in range(levels):
            pred = predictor(lattices[levels - level].astype(_I32))
            subbands.append(
                tuple(
                    ((t.astype(_I32) - pred) & 255).astype(_U8)
                    for t in quads[levels - level - 1]
                )
            )
        return anchors, subbands, (image[..., :h, :w] if want_recon else None)
    subbands = []
    for level in range(levels):
        s1 = 1 << (levels - level - 1)
        pred = predictor(coarse.astype(_I32))
        true_q = quads[levels - level - 1]
        masks = _quad_masks(pred.shape[-2], pred.shape[-1], s1, h, w, hp, wp)

        recon_q: List[jnp.ndarray] = []
        grid_q: List[jnp.ndarray] = []
        for t, mask in zip(true_q, masks):
            diff = (t.astype(_I32) - pred) & 255
            q = quantize(diff)
            fix = ((pred + q) > 255) != ((pred + diff) > 255)
            q = jnp.where(fix, diff, q)
            r = (pred + q) & 255
            if mask is not None:
                r = jnp.where(mask, r, 0)
            recon_q.append(r.astype(_U8))
            grid_q.append(q.astype(_U8))
        subbands.append(tuple(grid_q))
        if not want_recon and level == levels - 1:
            # The last interleave only feeds the recon output; predictions
            # never read it.
            return anchors, subbands, None
        coarse = _interleave4(coarse, *recon_q)
    return anchors, subbands, coarse[..., :h, :w]


def decode_subbands(
    anchors: jnp.ndarray,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    predictor: Callable[[jnp.ndarray], jnp.ndarray] = None,
) -> jnp.ndarray:
    """Decode subband layout back to the image plane (crop to ``shape``).

    The full decode is :func:`decode_preview` carried through every level.
    """
    return decode_preview(anchors, subbands, shape, levels, levels, predictor)


def decode_preview(
    anchors: jnp.ndarray,
    subbands,
    shape: Tuple[int, int],
    levels: int,
    upto: int,
    predictor: Callable[[jnp.ndarray], jnp.ndarray] = None,
) -> jnp.ndarray:
    """Progressive decode: reconstruct only the coarsest ``upto`` levels.

    Returns the 2**(levels-upto)-downsampled preview — exactly the full
    reconstruction sampled at the preview lattice
    (``preview[i, j] == full[i * s, j * s]`` with ``s = 2**(levels-upto)``),
    because refinement levels never modify coarser-lattice pixels.  With a
    subband-layout archive only the payload prefix up to level ``upto``
    needs entropy decoding (utils.container.read_thgi_preview), making
    preview cost proportional to preview area.  No reference counterpart
    (the reference always reconstructs fully, decoder.rs:18-46).
    """
    if predictor is None:
        predictor = cell_prediction
    h, w = shape
    levels = effective_levels(levels, h, w)
    upto = max(0, min(int(upto), levels))
    step = 1 << levels
    hp = _cdiv(h, step) * step
    wp = _cdiv(w, step) * step
    coarse = anchors.astype(_U8)
    for level in range(upto):
        s1 = 1 << (levels - level - 1)
        pred = predictor(coarse.astype(_I32))
        masks = _quad_masks(pred.shape[-2], pred.shape[-1], s1, h, w, hp, wp)
        recon_q = []
        for g, mask in zip(subbands[level], masks):
            r = (pred + g.astype(_I32)) & 255
            if mask is not None:
                r = jnp.where(mask, r, 0)
            recon_q.append(r.astype(_U8))
        coarse = _interleave4(coarse, *recon_q)
    s = 1 << (levels - upto)
    return coarse[..., : _cdiv(h, s), : _cdiv(w, s)]


def assemble_grid(anchors: jnp.ndarray, subbands, shape: Tuple[int, int]):
    """Interleave subband quads into the row-major residual grid plane.

    Pure data movement (the values already match :func:`encode_plane`'s
    grid bit-for-bit); used when .hgi interop requires row-major bytes.
    """
    h, w = shape
    grid = anchors
    for quads in subbands:
        grid = _interleave4(grid, *quads)
    return grid[..., :h, :w]


def split_grid(grid: jnp.ndarray, levels: int):
    """Inverse of :func:`assemble_grid`: row-major plane -> subband layout."""
    levels = effective_levels(levels, *grid.shape[-2:])
    grid = _pad_canvas(grid.astype(_U8), levels)
    anchors, quads, _ = _quad_pyramid(grid, levels)
    return anchors, [quads[levels - 1 - l] for l in range(levels)]
