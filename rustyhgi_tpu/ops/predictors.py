"""Interpolation predictors.

Device counterparts of the reference's pluggable interpolator
strategies (reference: src/interpolator.rs):

* ``crossed`` — the production predictor (interpolator.rs:57-91): mean of
  the four enclosing-cell corners via the exact integer rounding tree of
  interpolator.rs:41-55, out-of-bounds corners reading 0.
* ``left_top`` — the nearest-anchor predictor (interpolator.rs:15-28):
  the cell-origin value.  Bench-only in the reference (isolates traversal
  cost from prediction math); exposed here through the library API for the
  same purpose.

The reference's ``InterpolationType`` also names ``Line`` and ``Previous``
(interpolator.rs:4-9) but ships no implementation for either — they are
container metadata tags only (SURVEY.md C3), mirrored in
rustyhgi_tpu.utils.container.Interpolation.

Both predictors are position-independent within a cell (they read only
cell-corner state), which is what lets a whole pyramid level be computed
as one dense packed-lattice pass (see rustyhgi_tpu.ops.pyramid).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.container import Interpolation

__all__ = ["cell_prediction_crossed", "cell_prediction_left_top", "predictor_fn"]


def cell_prediction_crossed(coarse: jnp.ndarray) -> jnp.ndarray:
    """Crossed prediction for every cell of a packed int32 coarse lattice."""
    pad = [(0, 0)] * (coarse.ndim - 2) + [(0, 1), (0, 1)]
    p = jnp.pad(coarse, pad)
    tl = p[..., :-1, :-1]
    tr = p[..., :-1, 1:]
    bl = p[..., 1:, :-1]
    br = p[..., 1:, 1:]
    return (
        ((tl + tr + 1) >> 1)
        + ((bl + br + 1) >> 1)
        + ((tl + bl + 1) >> 1)
        + ((tr + br + 1) >> 1)
    ) >> 2


def cell_prediction_left_top(coarse: jnp.ndarray) -> jnp.ndarray:
    """LeftTop prediction: every cell predicts its origin corner value."""
    return coarse


_PREDICTORS = {
    "crossed": cell_prediction_crossed,
    "left_top": cell_prediction_left_top,
}

_TAGS = {
    "crossed": Interpolation.CROSSED,
    # left_top has no container tag in the reference enum; archives written
    # with it use the Previous tag slot only for metadata completeness.
    "left_top": Interpolation.PREVIOUS,
}


def predictor_fn(name: str):
    """Resolve a predictor name to its packed-lattice cell function."""
    try:
        return _PREDICTORS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown predictor {name!r}; expected one of {sorted(_PREDICTORS)}"
        ) from None


def predictor_tag(name: str) -> int:
    return _TAGS[name.lower()]


def predictor_name_for_tag(tag: int) -> str:
    """Resolve a container interpolation tag to a predictor name.

    CROSSED decodes with crossed, PREVIOUS with left_top (the tag this
    framework writes for left_top archives — see _TAGS above).  LINE has
    no implementation in the reference either (interpolator.rs:4-9 names
    it, nothing implements it); the reference decodes everything with
    Crossed (main.rs:67), so LINE falls back to crossed here too.
    """
    if tag == Interpolation.PREVIOUS:
        return "left_top"
    return "crossed"
