"""Engine policy: which device engine runs a configuration.

Two engines produce the same bytes (both are bit-exact against
rustyhgi_tpu.oracle): the planar engine (ops.planar) and the dyadic
engine (ops.pyramid).  This module is the one place that chooses between
them; HGICodec, the sharded tier and the CLI all call it.
"""

from __future__ import annotations

from .planar import supported_planar

__all__ = ["ENGINES", "choose_engine"]

ENGINES = ("auto", "planar", "xla")


def choose_engine(engine: str, levels: int, h: int, w: int, quantize,
                  predictor: str, batch: int = 1) -> str:
    """Resolve ``engine`` ("auto" | "planar" | "xla") to "planar" or "xla".

    ``auto`` takes the planar engine for a single plane (``batch`` is the
    number of planes one device program processes) wherever it covers
    the configuration (levels >= 2 after clamping, linear or identity
    quantizer, Crossed or LeftTop predictor), and the dyadic engine for
    batches and everywhere else.  On the H100 the planar engine is the
    faster one for one plane in nearly every measured op and size, and
    the dyadic one for batches of 1080p and larger planes (PERF.md).  An
    explicit engine is honoured or refused, never silently replaced.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    covered = supported_planar(levels, h, w, quantize, predictor)
    if engine == "auto":
        return "planar" if covered and batch == 1 else "xla"
    if engine == "planar" and not covered:
        raise ValueError(
            f"engine='planar' does not cover levels={levels}, "
            f"shape=({h}, {w}), quantizer={quantize!r}, "
            f"predictor={predictor!r}"
        )
    return engine
