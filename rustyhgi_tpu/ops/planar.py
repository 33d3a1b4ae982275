"""Planar-dataflow codec engine: the whole pyramid as one XLA program.

The dyadic engine (ops.pyramid) splits and interleaves lattices level by
level.  This engine instead works on the 16 stride-4 byte planes of the
canvas, so the two finest levels (93.75% of the pixels for levels >= 2)
need only elementwise arithmetic:

* the canvas is bitcast to **uint32 words** (4 pixels per word);
  extracting byte ``rx`` of row-residue ``ry`` yields the plane
  ``D[ry][rx]`` (``D[ry][rx][i, j] == X[4i + ry, 4j + rx]``) with shifts
  and masks plus one row reshape;
* the two finest pyramid levels read and write only those planes: cell
  corners are plane selections plus single-step shifts, the Crossed
  rounding tree (reference src/interpolator.rs:41-55) and the
  quantize/overflow-fixup closed loop (src/encoder.rs:53-64) are
  elementwise on them;
* coarser levels recurse on the stride-4 sub-lattice ``D[0][0]`` — 1/16
  of the area — so their split/assemble cost decays as 4**-depth;
* the residual grid (the reference's own Grid form, src/grid.rs:8-27) is
  re-packed into uint32 words elementwise, and the subband layout
  (ops.pyramid.encode_subbands) is the per-level planes themselves.

Every function here is plain ``jnp``/``lax`` and compiles as one jit per
shape on any backend.  Outputs are bit-identical to rustyhgi_tpu.oracle
and to ops.pyramid, so the choice between the two engines
(ops.engine.choose_engine) is pure speed policy.

Reference semantics: src/encoder.rs:39-71, src/decoder.rs:18-46; see
SURVEY.md §3.5-3.6.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..dyadic import cdiv, effective_levels
from .quantizers import LinearQuantizer, NoOpQuantizer

__all__ = [
    "supported_planar",
    "encode_plane_planar",
    "encode_subbands_planar",
    "decode_plane_planar",
    "decode_subbands_planar",
]

_I32 = jnp.int32
_U8 = jnp.uint8
_U32 = jnp.uint32
_PT = _I32  # plane element type


def _avg(a, b):
    """(a + b + 1) >> 1 per pixel (round-half-up; interpolator.rs:41-46)."""
    return (a + b + 1) >> 1


def _tree_crossed(tl, tr, bl, br):
    """The exact integer rounding tree of src/interpolator.rs:41-55."""
    t = _avg(tl, tr) + _avg(bl, br) + _avg(tl, bl) + _avg(tr, br)
    return t >> 2


def _tree_left_top(tl, tr, bl, br):
    """LeftTop predictor (src/interpolator.rs:15-28): the cell origin."""
    return tl


_TREES = {"crossed": _tree_crossed, "left_top": _tree_left_top}


def supported_planar(levels: int, h: int, w: int, quantize, predictor) -> bool:
    """Whether this engine covers the configuration.

    Outside it (levels < 2 after clamping, LUT/table quantizers, other
    predictors) the dyadic engine serves — same bits.
    """
    if effective_levels(levels, h, w) < 2 or predictor not in _TREES:
        return False
    if quantize is None or isinstance(quantize, (LinearQuantizer, NoOpQuantizer)):
        return True
    return bool(getattr(quantize, "identity", False))


def _norm_quantize(quantize):
    """None (statically lossless) or a LinearQuantizer."""
    if quantize is None or getattr(quantize, "identity", False):
        return None
    if isinstance(quantize, LinearQuantizer):
        return None if quantize.error == 0 else quantize
    raise ValueError(f"unsupported quantizer for the planar engine: {quantize!r}")


# -- plane helpers --------------------------------------------------------------


def _shift_lane(p: jnp.ndarray) -> jnp.ndarray:
    """out[i, j] = p[i, j+1]; zero fill at the right edge.

    Planes span the full canvas width, so the last column *is* the canvas
    edge and zero fill reproduces the reference's
    out-of-bounds-corners-read-0 rule (src/interpolator.rs:75-82).
    """
    return jnp.pad(p[..., 1:], ((0, 0), (0, 1)))


def _shift_sub(p: jnp.ndarray) -> jnp.ndarray:
    """out[i, j] = p[i+1, j]; zero fill at the canvas bottom."""
    return jnp.pad(p[1:], ((0, 1), (0, 0)))


def _planes_k(X: jnp.ndarray, k: int):
    """Split an (m, n) lattice into its k*k stride-k planes.

    ``out[ry][rx][i, j] == X[k*i + ry, k*j + rx]``.
    """
    m, n = X.shape
    r = X.reshape(m // k, k, n // k, k)
    return [[r[:, ry, :, rx] for rx in range(k)] for ry in range(k)]


def _assemble(planes) -> jnp.ndarray:
    """Inverse of :func:`_planes_k`: k*k stride-k planes -> (m, n) array."""
    k = len(planes)
    mq, nq = planes[0][0].shape
    st = jnp.stack([jnp.stack(row, axis=-1) for row in planes], axis=1)
    return st.reshape(mq * k, nq * k)


class _Masks:
    """In-image masks for closed-loop recon (reference OOB contract).

    A plane position (i, j) with row/col offsets (oy, ox) and steps
    (sy, sx) maps to canvas pixel (oy + i*sy, ox + j*sx); reconstruction
    outside the true (h, w) image is forced to 0 so corner reads of
    padded positions agree with the reference's out-of-bounds-reads-0
    rule.  Axes fully covered by the image are statically skipped.
    """

    def __init__(self, h, w, hp, wp):
        self.h, self.w = h, w
        self.need_y = hp > h
        self.need_x = wp > w

    def __call__(self, shape, oy, sy, ox, sx):
        m = None
        if self.need_y:
            thr = (self.h - oy + sy - 1) // sy
            m = lax.broadcasted_iota(_I32, shape, 0) < thr
        if self.need_x:
            thrx = (self.w - ox + sx - 1) // sx
            mx = lax.broadcasted_iota(_I32, shape, 1) < thrx
            m = mx if m is None else (m & mx)
        return m


def _no_mask(shape, oy, sy, ox, sx):
    return None


def _code(fine, pred, quantize, mask):
    """One closed-loop residual step (src/encoder.rs:53-64).

    Returns (grid_byte, recon_byte) as int32 in [0, 255].  ``quantize``
    None means the statically-lossless path: q == diff, the overflow
    fixup cannot trigger, and recon == fine exactly.
    """
    diff = (fine - pred) & 255
    if quantize is None:
        return diff, fine
    q = quantize(diff)
    fix = ((pred + q) > 255) != ((pred + diff) > 255)
    g = jnp.where(fix, diff, q)
    r = (pred + g) & 255
    if mask is not None:
        r = jnp.where(mask, r, 0)
    return g, r


def _cell_preds(tree, c00, c01, c10, c11):
    """Predictions of the four spacing-1 sub-cells of a spacing-2 lattice.

    ``c00..c11`` are the spacing-2 recon planes; the (a, b) prediction
    serves pixels (4i + 2a + {0,1}, 4j + 2b + {0,1}) minus the corner.
    """
    sl00 = _shift_lane(c00)
    sl10 = _shift_lane(c10)
    ss01 = _shift_sub(c01)
    return {
        (0, 0): tree(c00, c01, c10, c11),
        (0, 1): tree(c01, sl00, c11, sl10),
        (1, 0): tree(c10, c11, _shift_sub(c00), ss01),
        (1, 1): tree(c11, sl10, ss01, _shift_sub(sl00)),
    }


def _corner_pred(tree, C):
    trs = _shift_lane(C)
    return tree(C, trs, _shift_sub(C), _shift_sub(trs))


# Fine-level plane slots of sub-cell (a, b): q01, q10, q11.
def _fine_slots(a, b):
    return (
        (2 * a, 2 * b + 1),
        (2 * a + 1, 2 * b),
        (2 * a + 1, 2 * b + 1),
    )


# -- encode ---------------------------------------------------------------------


def _encode_core(D, lrem, quantize, tree, maskf, sy, sx, sub=False):
    """Two pyramid levels on a planar-decomposed lattice + recursion.

    ``D[ry][rx]`` are the 16 stride-4 planes of the current lattice
    (spacing (sy, sx) in canvas pixels).  Returns ``(grid_planes,
    recon_planes, subinfo)`` — 4x4 plane lists (``recon_planes`` is None
    on the lossless path, where recon == source).  With ``sub=True`` the
    recursion collects the subband emission instead of assembling a
    sub-grid: ``grid_planes[0][0]`` is None and ``subinfo`` is
    ``(anchor_plane, levels_list)`` per :func:`_sub_arr`.
    """
    lossless = quantize is None
    S = D[0][0]
    subinfo = None
    if lrem == 2:
        gsub, rsub = S, S  # anchors: raw values (src/encoder.rs:26-37)
        if sub:
            gsub, subinfo = None, (S, [])
    elif sub:
        anc, levels_sub, rsub = _sub_arr(
            S, lrem - 2, quantize, tree, maskf, 4 * sy, 4 * sx
        )
        gsub, subinfo = None, (anc, levels_sub)
    else:
        gsub, rsub = _encode_arr(S, lrem - 2, quantize, tree, maskf, 4 * sy, 4 * sx)

    # Level A: coarse spacing 4, fine spacing 2 (relative to this lattice).
    C = S if lossless else rsub
    P = _corner_pred(tree, C)
    sh = P.shape
    gA01, rA01 = _code(D[0][2], P, quantize, maskf(sh, 0, 4 * sy, 2 * sx, 4 * sx))
    gA10, rA10 = _code(D[2][0], P, quantize, maskf(sh, 2 * sy, 4 * sy, 0, 4 * sx))
    gA11, rA11 = _code(D[2][2], P, quantize, maskf(sh, 2 * sy, 4 * sy, 2 * sx, 4 * sx))

    # Level B: coarse spacing 2, fine spacing 1.  The spacing-2 recon
    # lattice is exactly {C, rA01, rA10, rA11} by coordinate identity.
    if lossless:
        corners = (S, D[0][2], D[2][0], D[2][2])
    else:
        corners = (C, rA01, rA10, rA11)
    preds = _cell_preds(tree, *corners)

    gp = [[None] * 4 for _ in range(4)]
    rp = [[None] * 4 for _ in range(4)]
    gp[0][0], rp[0][0] = gsub, rsub
    gp[0][2], rp[0][2] = gA01, rA01
    gp[2][0], rp[2][0] = gA10, rA10
    gp[2][2], rp[2][2] = gA11, rA11
    for (a, b), Pab in preds.items():
        for ry, rx in _fine_slots(a, b):
            gp[ry][rx], rp[ry][rx] = _code(
                D[ry][rx], Pab, quantize,
                maskf(Pab.shape, ry * sy, 4 * sy, rx * sx, 4 * sx),
            )
    return gp, (None if lossless else rp), subinfo


def _encode_level1(X, quantize, tree, maskf, sy, sx):
    """One pyramid level on an (m, n) lattice: (C, grid quads, recon quads)."""
    p4 = _planes_k(X, 2)
    C = p4[0][0]
    P = _corner_pred(tree, C)
    sh = P.shape
    g01, r01 = _code(p4[0][1], P, quantize, maskf(sh, 0, 2 * sy, sx, 2 * sx))
    g10, r10 = _code(p4[1][0], P, quantize, maskf(sh, sy, 2 * sy, 0, 2 * sx))
    g11, r11 = _code(p4[1][1], P, quantize, maskf(sh, sy, 2 * sy, sx, 2 * sx))
    return C, (g01, g10, g11), (r01, r10, r11)


def _encode_arr(X, lrem, quantize, tree, maskf, sy, sx):
    """Encode a materialized (m, n) lattice; returns (grid, recon) arrays."""
    lossless = quantize is None
    if lrem == 0:
        return X, X
    if lrem == 1:
        C, (g01, g10, g11), (r01, r10, r11) = _encode_level1(
            X, quantize, tree, maskf, sy, sx
        )
        G = _assemble([[C, g01], [g10, g11]])
        R = X if lossless else _assemble([[C, r01], [r10, r11]])
        return G, R
    gp, rp, _ = _encode_core(_planes_k(X, 4), lrem, quantize, tree, maskf, sy, sx)
    return _assemble(gp), (X if rp is None else _assemble(rp))


# -- subband emission -----------------------------------------------------------
#
# The per-level planes ARE the subband decomposition; emission only has
# to put them in the pyramid.encode_subbands byte layout.  Two forms
# cover every level:
#
# * ``("pairs", q)`` — the FINEST level of each recursion depth.  A quad
#   like q01 alternates two column-residue planes byte-for-byte
#   (cols 2c+1: residue 1 then 3), so each u16 of its row-major bytes is
#   ``A | B << 8`` — pure elementwise — and rows interleave the two
#   row-residue planes with one stack.  ``q`` is that int32 array
#   (values < 2**16), bitcast to bytes at the end.
# * ``("vals", q)`` — level-A quads / anchors / odd-tail quads are single
#   stride-4 planes already in row-major order; ``q`` holds one byte
#   value per element.


def _pair(A0, B0, A2, B2):
    """Pair-pack a finest-level quad: (rows r even: A0|B0<<8; odd: A2|B2<<8)."""
    u0 = A0 | (B0 << 8)
    u2 = A2 | (B2 << 8)
    st = jnp.stack([u0, u2], axis=-2)  # [m, 2, n]
    return st.reshape(2 * u0.shape[-2], u0.shape[-1])


# Plane slots of the (A0, B0, A2, B2) pair operands of each finest quad.
_PAIR_SLOTS = (
    ((0, 1), (0, 3), (2, 1), (2, 3)),  # q01: (2r, 2c+1)
    ((1, 0), (1, 2), (3, 0), (3, 2)),  # q10: (2r+1, 2c)
    ((1, 1), (1, 3), (3, 1), (3, 3)),  # q11: (2r+1, 2c+1)
)


def _sub_levels_from_gp(gp):
    """(level_A_entry, level_B_entry) from a 4x4 grid-plane list."""
    level_a = ("vals", (gp[0][2], gp[2][0], gp[2][2]))
    level_b = (
        "pairs",
        tuple(
            _pair(*(gp[ry][rx] for ry, rx in slots)) for slots in _PAIR_SLOTS
        ),
    )
    return level_a, level_b


def _sub_arr(X, lrem, quantize, tree, maskf, sy, sx):
    """Subband-encode a materialized lattice.

    Returns ``(anchor_plane, levels_list, recon)`` — levels coarsest
    first, ``recon`` the assembled reconstruction lattice the PARENT
    level predicts from (== X when lossless).
    """
    lossless = quantize is None
    if lrem == 0:
        return X, [], X
    if lrem == 1:
        C, quads, (r01, r10, r11) = _encode_level1(
            X, quantize, tree, maskf, sy, sx
        )
        R = X if lossless else _assemble([[C, r01], [r10, r11]])
        return C, [("vals", quads)], R
    gp, rp, (anc, levels_sub) = _encode_core(
        _planes_k(X, 4), lrem, quantize, tree, maskf, sy, sx, sub=True
    )
    level_a, level_b = _sub_levels_from_gp(gp)
    recon = X if rp is None else _assemble(rp)
    return anc, levels_sub + [level_a, level_b], recon


def _sub_layout(levels: int):
    """Emission kinds of the subband levels, coarsest first.

    Mirrors the recursion in :func:`_encode_core`/:func:`_sub_arr`.
    """
    kinds = ["vals", "pairs"] * (levels // 2)
    return (["vals"] if levels % 2 else []) + kinds


# -- words <-> planes -----------------------------------------------------------


def _canvas_words(image, hp, wp):
    """uint8 [H, W] -> zero-padded u32-word canvas [hp, wp//4]."""
    h, w = image.shape
    padded = jnp.pad(image, ((0, hp - h), (0, wp - w)))
    return lax.bitcast_convert_type(padded.reshape(hp, wp // 4, 4), _U32)


def _from_words(xw: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    n, rows, wc = xw.shape
    x = lax.bitcast_convert_type(xw[..., None], _U8).reshape(n, rows, wc * 4)
    return x[:, :h, :w]


def _bytes16_from_u32(xw: jnp.ndarray):
    """uint32 (r, wc) canvas words -> 16 stride-4 planes (_PT), elementwise."""
    r, wc = xw.shape
    r4 = xw.reshape(r // 4, 4, wc)
    return [
        [((r4[:, ry, :] >> _U32(8 * rx)) & _U32(255)).astype(_PT) for rx in range(4)]
        for ry in range(4)
    ]


def _pack_u32(planes) -> jnp.ndarray:
    """16 byte planes -> uint32 grid words, elementwise."""
    words = []
    for ry in range(4):
        w = planes[ry][0].astype(_U32)
        for rx in range(1, 4):
            w = w | (planes[ry][rx].astype(_U32) << _U32(8 * rx))
        words.append(w)
    stacked = jnp.stack(words, axis=1)  # (mq, 4, wc)
    return stacked.reshape(stacked.shape[0] * 4, stacked.shape[2])


# -- decode ---------------------------------------------------------------------


def _dec(res, pred, mask):
    r = (pred + res) & 255
    if mask is not None:
        r = jnp.where(mask, r, 0)
    return r


def _decode_core(Dg, lrem, tree, maskf, sy, sx):
    """Mirror of :func:`_encode_core`: grid planes -> recon planes."""
    if lrem == 2:
        S = Dg[0][0]  # anchors are stored raw
    else:
        S = _decode_arr(Dg[0][0], lrem - 2, tree, maskf, 4 * sy, 4 * sx)
    P = _corner_pred(tree, S)
    sh = P.shape
    rA01 = _dec(Dg[0][2], P, maskf(sh, 0, 4 * sy, 2 * sx, 4 * sx))
    rA10 = _dec(Dg[2][0], P, maskf(sh, 2 * sy, 4 * sy, 0, 4 * sx))
    rA11 = _dec(Dg[2][2], P, maskf(sh, 2 * sy, 4 * sy, 2 * sx, 4 * sx))

    preds = _cell_preds(tree, S, rA01, rA10, rA11)
    rp = [[None] * 4 for _ in range(4)]
    rp[0][0], rp[0][2], rp[2][0], rp[2][2] = S, rA01, rA10, rA11
    for (a, b), Pab in preds.items():
        for ry, rx in _fine_slots(a, b):
            rp[ry][rx] = _dec(
                Dg[ry][rx], Pab,
                maskf(Pab.shape, ry * sy, 4 * sy, rx * sx, 4 * sx),
            )
    return rp


def _decode_arr(G, lrem, tree, maskf, sy, sx):
    if lrem == 0:
        return G
    if lrem == 1:
        p4 = _planes_k(G, 2)
        C = p4[0][0]
        P = _corner_pred(tree, C)
        sh = P.shape
        r01 = _dec(p4[0][1], P, maskf(sh, 0, 2 * sy, sx, 2 * sx))
        r10 = _dec(p4[1][0], P, maskf(sh, sy, 2 * sy, 0, 2 * sx))
        r11 = _dec(p4[1][1], P, maskf(sh, sy, 2 * sy, sx, 2 * sx))
        return _assemble([[C, r01], [r10, r11]])
    return _assemble(_decode_core(_planes_k(G, 4), lrem, tree, maskf, sy, sx))


# -- subband-direct decode: emission quads -> grid planes ----------------------


def _unsub_gp(anchor, entries, lrem):
    """4x4 grid-plane list of the top lattice (lrem >= 2) — inverse of
    :func:`_sub_levels_from_gp` + recursion."""
    (_, pairs_b) = entries[-1]
    (_, vals_a) = entries[-2]
    gp = [[None] * 4 for _ in range(4)]
    gp[0][0] = _unsub_arr(anchor, entries[:-2], lrem - 2)
    gp[0][2], gp[2][0], gp[2][2] = vals_a
    for q, slots in zip(pairs_b, _PAIR_SLOTS):
        m2, n = q.shape
        st = q.reshape(m2 // 2, 2, n)
        u0, u2 = st[:, 0, :], st[:, 1, :]
        for (ry, rx), plane in zip(
            slots, (u0 & 255, u0 >> 8, u2 & 255, u2 >> 8)
        ):
            gp[ry][rx] = plane
    return gp


def _unsub_arr(anchor, entries, lrem):
    """Grid lattice from (anchor plane, emission entries) — inverse of
    :func:`_sub_arr`."""
    if lrem == 0:
        return anchor
    if lrem == 1:
        (_, (g01, g10, g11)) = entries[-1]
        return _assemble([[anchor, g01], [g10, g11]])
    return _assemble(_unsub_gp(anchor, entries, lrem))


# -- batched programs -----------------------------------------------------------
#
# A batch is one vmap over planes.  (Running it as sequential 8-plane
# chunks under lax.map was no faster on the H100 at batch 16 and 32, and
# slower for lossy presets; PERF.md.)


def _canvas(h, w, levels):
    step = 1 << levels
    return cdiv(h, step) * step, cdiv(w, step) * step


def _encode_setup(image, levels, error):
    h, w = image.shape[-2:]
    levels = effective_levels(levels, h, w)
    quantize = None if error is None else LinearQuantizer(error)
    hp, wp = _canvas(h, w, levels)
    maskf = _no_mask if quantize is None else _Masks(h, w, hp, wp)
    return h, w, levels, quantize, hp, wp, maskf


@partial(
    jax.jit, static_argnames=("levels", "error", "predictor", "want_recon")
)
def _encode_batch(image, levels, error, predictor, want_recon):
    h, w, levels, quantize, hp, wp, maskf = _encode_setup(image, levels, error)
    tree = _TREES[predictor]
    lossless = quantize is None
    emit_recon = want_recon and not lossless

    def one(im):
        D = _bytes16_from_u32(_canvas_words(im, hp, wp))
        gp, rp, _ = _encode_core(D, levels, quantize, tree, maskf, 1, 1)
        grid = _pack_u32(gp)
        return grid, (_pack_u32(rp) if emit_recon else grid)

    gw, rw = jax.vmap(one)(image)
    grid = _from_words(gw, h, w)
    if not want_recon:
        return grid, None
    return grid, (image if lossless else _from_words(rw, h, w))


@partial(
    jax.jit, static_argnames=("levels", "error", "predictor", "want_recon")
)
def _encode_sub_batch(image, levels, error, predictor, want_recon):
    h, w, levels, quantize, hp, wp, maskf = _encode_setup(image, levels, error)
    tree = _TREES[predictor]
    lossless = quantize is None
    emit_recon = want_recon and not lossless

    def one(im):
        D = _bytes16_from_u32(_canvas_words(im, hp, wp))
        gp, rp, (anc, levels_sub) = _encode_core(
            D, levels, quantize, tree, maskf, 1, 1, sub=True
        )
        entries = levels_sub + list(_sub_levels_from_gp(gp))
        outs = [anc.astype(jnp.uint16)] + [
            q.astype(jnp.uint16) for _, quads in entries for q in quads
        ]
        return outs, (_pack_u32(rp) if emit_recon else outs[0])

    outs, rw = jax.vmap(one)(image)

    def to_bytes(x, kind):
        if kind == "vals":
            return x.astype(_U8)
        u8 = lax.bitcast_convert_type(x[..., None], _U8)
        return u8.reshape(*x.shape[:-1], 2 * x.shape[-1])

    anchors = to_bytes(outs[0], "vals")
    subbands = [
        tuple(to_bytes(outs[1 + 3 * i + j], kind) for j in range(3))
        for i, kind in enumerate(_sub_layout(levels))
    ]
    if not want_recon:
        return anchors, subbands, None
    if lossless:
        return anchors, subbands, image
    return anchors, subbands, _from_words(rw, h, w)


@partial(jax.jit, static_argnames=("levels", "predictor"))
def _decode_batch(grid, levels, predictor):
    h, w = grid.shape[-2:]
    levels = effective_levels(levels, h, w)
    hp, wp = _canvas(h, w, levels)
    tree = _TREES[predictor]
    maskf = _Masks(h, w, hp, wp)

    def one(g):
        Dg = _bytes16_from_u32(_canvas_words(g, hp, wp))
        return _pack_u32(_decode_core(Dg, levels, tree, maskf, 1, 1))

    return _from_words(jax.vmap(one)(grid), h, w)


@partial(jax.jit, static_argnames=("levels", "predictor", "h", "w"))
def _decode_sub_batch(anchors, flat_quads, levels, predictor, h, w):
    hp, wp = _canvas(h, w, levels)
    tree = _TREES[predictor]
    maskf = _Masks(h, w, hp, wp)
    layout = _sub_layout(levels)

    def one(anc, quads):
        entries = []
        for i, kind in enumerate(layout):
            qs = []
            for q in quads[3 * i: 3 * i + 3]:
                if kind == "pairs":
                    m, k2 = q.shape
                    q = lax.bitcast_convert_type(
                        q.reshape(m, k2 // 2, 2), jnp.uint16
                    )
                qs.append(q.astype(_PT))
            entries.append((kind, tuple(qs)))
        gp = _unsub_gp(anc.astype(_PT), entries, levels)
        return _pack_u32(_decode_core(gp, levels, tree, maskf, 1, 1))

    out = jax.vmap(one)(anchors, list(flat_quads))
    return _from_words(out, h, w)


# -- public wrappers ------------------------------------------------------------


def encode_plane_planar(
    image: jnp.ndarray,
    levels: int,
    quantize=None,
    predictor: str = "crossed",
    want_recon: bool = True,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """Planar counterpart of ops.pyramid.encode_plane — bit-identical.

    ``image`` is uint8 [H, W] or [B, H, W]; returns ``(grid, recon)``
    (``recon`` None when ``want_recon`` is False).
    """
    image = jnp.asarray(image, _U8)
    squeeze = image.ndim == 2
    if squeeze:
        image = image[None]
    q = _norm_quantize(quantize)
    grid, recon = _encode_batch(
        image, int(levels), (None if q is None else q.error), predictor,
        want_recon,
    )
    if squeeze:
        grid = grid[0]
        recon = None if recon is None else recon[0]
    return grid, recon


def encode_subbands_planar(
    image: jnp.ndarray,
    levels: int,
    quantize=None,
    predictor: str = "crossed",
    want_recon: bool = True,
):
    """Planar counterpart of ops.pyramid.encode_subbands — bit-identical."""
    image = jnp.asarray(image, _U8)
    squeeze = image.ndim == 2
    if squeeze:
        image = image[None]
    q = _norm_quantize(quantize)
    anchors, subbands, recon = _encode_sub_batch(
        image, int(levels), (None if q is None else q.error), predictor,
        want_recon,
    )
    if squeeze:
        anchors = anchors[0]
        subbands = [tuple(x[0] for x in quads) for quads in subbands]
        recon = None if recon is None else recon[0]
    return anchors, subbands, recon


def decode_plane_planar(
    grid: jnp.ndarray, levels: int, predictor: str = "crossed"
) -> jnp.ndarray:
    """Planar counterpart of ops.pyramid.decode_plane — bit-identical."""
    grid = jnp.asarray(grid, _U8)
    squeeze = grid.ndim == 2
    if squeeze:
        grid = grid[None]
    out = _decode_batch(grid, int(levels), predictor)
    return out[0] if squeeze else out


def decode_subbands_planar(
    anchors, subbands, shape, levels: int, predictor: str = "crossed"
) -> jnp.ndarray:
    """Planar counterpart of ops.pyramid.decode_subbands — bit-identical."""
    anchors = jnp.asarray(anchors, _U8)
    squeeze = anchors.ndim == 2
    if squeeze:
        anchors = anchors[None]
        subbands = [tuple(q[None] for q in quads) for quads in subbands]
    flat = tuple(jnp.asarray(q, _U8) for quads in subbands for q in quads)
    h, w = shape
    out = _decode_sub_batch(
        anchors, flat, effective_levels(int(levels), h, w), predictor, h, w
    )
    return out[0] if squeeze else out
