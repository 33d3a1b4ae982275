"""Residual quantizers.

Device re-design of the reference's quantizer strategies
(reference: src/quantizator.rs:1-73).  The reference materializes a 256-entry
LUT indexed by the wrapped residual byte; on the device we prefer the closed-form
arithmetic (integer multiply/shift after XLA strength reduction) which fuses
into the per-level elementwise kernel, but we also expose the LUT for
table-driven quantizers and for the host oracle.

Quantizer contract (quantizator.rs:12-15): ``quantize(residual_byte) ->
quantized_byte`` plus a max-error bound ``error()``.

Linear quantizer (quantizator.rs:36-73): error ``e`` in
{Lossless: 0, Low: 10, Medium: 20, High: 30}; ``scale = 2e+1``;
``q(x) = ((x + e) // scale) * scale`` computed in wide ints then truncated to
u8.  At e=0 this is the identity, giving exactly lossless reconstruction.
"""

from __future__ import annotations

import enum
from typing import Callable

import numpy as np

__all__ = [
    "QuantizationLevel",
    "linear_error",
    "linear_table",
    "linear_quantize",
    "noop_quantize",
    "quantize_fn",
    "LinearQuantizer",
    "NoOpQuantizer",
    "LUTQuantizer",
]


class QuantizationLevel(enum.IntEnum):
    """Quality presets; integer values are the container enum tags.

    Tag order must match the reference's serde enum order
    (quantizator.rs:1-9) for .hgi container compatibility: Lossless=0,
    Low=1, Medium=2, High=3.
    """

    LOSSLESS = 0
    LOW = 1
    MEDIUM = 2
    HIGH = 3

    @classmethod
    def parse(cls, name: str) -> "QuantizationLevel":
        try:
            return cls[name.upper()]
        except KeyError:
            raise ValueError(
                f"unknown quantization level {name!r}; "
                f"expected one of {[m.name.lower() for m in cls]}"
            ) from None


_ERRORS = {
    QuantizationLevel.LOSSLESS: 0,
    QuantizationLevel.LOW: 10,
    QuantizationLevel.MEDIUM: 20,
    QuantizationLevel.HIGH: 30,
}


def linear_error(level: QuantizationLevel) -> int:
    """Max abs reconstruction error for a preset (quantizator.rs:43-48)."""
    return _ERRORS[QuantizationLevel(level)]


def linear_table(level: QuantizationLevel) -> np.ndarray:
    """The 256-entry LUT of quantizator.rs:50-61 as uint8[256]."""
    e = linear_error(level)
    scale = 2 * e + 1
    x = np.arange(256, dtype=np.int64)
    return (((x + e) // scale) * scale).astype(np.uint8)  # `as u8` truncation


def linear_quantize(diff, error: int):
    """Closed-form Linear quantizer on int32 residual bytes in [0, 255].

    Works on NumPy and JAX arrays alike.  The ``& 255`` reproduces the
    reference's ``as u8`` truncation (quantizator.rs:54).
    """
    scale = 2 * error + 1
    return (((diff + error) // scale) * scale) & 255


def noop_quantize(diff, error: int = 0):
    """NoOp quantizer (quantizator.rs:17-34) — identity."""
    return diff


def _magic_divider(divisor: int, max_x: int):
    """Exact (multiplier, shift) with ``(x * m) >> s == x // divisor``
    for all x in [0, max_x].

    XLA lowers int32 ``//`` by a constant through a signed-division
    sequence that measures ~27% slower end-to-end than a plain
    multiply+shift on the VPU; the quantizer's domain is tiny (x <= 255 +
    error), so a small exact magic always exists.  Exhaustively verified
    over the full domain at construction time (static per preset).
    """
    x = np.arange(max_x + 1, dtype=np.int64)
    want = x // divisor
    for shift in range(16, 31):
        mult = -(-(1 << shift) // divisor)  # ceil(2^shift / divisor)
        if mult * max_x >= 1 << 31:
            continue
        if np.array_equal((x * mult) >> shift, want):
            return int(mult), int(shift)
    raise AssertionError(f"no exact magic divider for {divisor} on [0, {max_x}]")


class LinearQuantizer:
    """Callable linear quantizer carrying its max-error bound.

    Exposing ``error`` statically lets the device kernels specialize: at
    ``error == 0`` the quantizer is the identity, so the residual pass can
    skip quantization and the overflow fixup entirely (the fixup can never
    trigger when q == diff) and reconstruct losslessly as ``recon = true``.
    """

    def __init__(self, error: int):
        self.error = int(error)
        if self.error > 0:
            # Device fast path: exact multiply-shift division (see
            # _magic_divider).  Domain is diff + error with diff a wrapped
            # byte, so max input is 255 + error.
            self._mult, self._shift = _magic_divider(
                2 * self.error + 1, 255 + self.error
            )

    def __call__(self, diff):
        if self.error == 0:
            return diff
        scale = 2 * self.error + 1
        q = ((diff + self.error) * self._mult) >> self._shift
        return (q * scale) & 255

    @property
    def identity(self) -> bool:
        return self.error == 0

    def __repr__(self) -> str:
        return f"LinearQuantizer(error={self.error})"


class NoOpQuantizer:
    """NoOp quantizer strategy (quantizator.rs:17-34): identity, error 0.

    Unlike ``Linear(Lossless)`` this never touches a table — the device
    encode specializes it away entirely (``identity = True`` drives the
    lossless fast path in ops.pyramid), exactly mirroring the reference's
    NoOp-vs-Linear bench pairs which isolate LUT cost.
    """

    error = 0
    identity = True

    def __call__(self, diff):
        return diff

    def __repr__(self) -> str:
        return "NoOpQuantizer()"


class LUTQuantizer:
    """Table-driven Linear quantizer: a real 256-entry gather per residual.

    The faithful counterpart of the reference's ``Linear`` strategy
    (quantizator.rs:36-73 materializes a 256-entry table and indexes it
    per pixel).  Values are bit-identical to :class:`LinearQuantizer`;
    only the mechanism differs (device table gather vs fused closed-form
    multiply-shift).  ``identity = False`` always, so even the Lossless
    LUT runs the full closed loop — this is what makes the benchmark
    suite's ``*_quanted`` rows measure table-lookup cost against the
    ``*_nop`` rows (benches/bench.rs:54-96).
    """

    identity = False

    def __init__(self, error: int):
        self.error = int(error)
        scale = 2 * self.error + 1
        x = np.arange(256, dtype=np.int64)
        self._table = (((x + self.error) // scale) * scale) & 255  # int64

    def __call__(self, diff):
        if isinstance(diff, np.ndarray):
            return self._table[diff & 255].astype(diff.dtype)
        import jax.numpy as jnp

        table = jnp.asarray(self._table, jnp.int32)
        return jnp.take(table, diff & 255, axis=0)

    def __repr__(self) -> str:
        return f"LUTQuantizer(error={self.error})"


_STRATEGIES = ("linear", "noop", "lut")


def quantize_fn(level: QuantizationLevel, strategy: str = "linear"):
    """Return ``f(diff_int32) -> quantized_int32`` for a preset.

    The returned callable is traceable by JAX (pure elementwise integer
    math) and fuses into the per-level kernel; its ``.error`` attribute is
    the static max-error bound and ``.identity`` drives the lossless
    fast-path specialization.

    ``strategy`` picks the quantizer mechanism, mirroring the reference's
    pluggable ``Quantizator`` strategies (quantizator.rs:12-15):
    ``linear`` (closed-form multiply-shift, the production path),
    ``noop`` (NoOp — identity, quantizator.rs:17-34), ``lut`` (table-driven
    Linear — a real 256-entry gather, quantizator.rs:62-68).
    """
    if strategy == "linear":
        return LinearQuantizer(linear_error(level))
    if strategy == "noop":
        return NoOpQuantizer()
    if strategy == "lut":
        return LUTQuantizer(linear_error(level))
    raise ValueError(
        f"unknown quantizer strategy {strategy!r}; expected one of {_STRATEGIES}"
    )
