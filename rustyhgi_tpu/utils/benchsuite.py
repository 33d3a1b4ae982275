"""Benchmark suite mirroring the reference's criterion benches.

One entry per reference bench (reference: benches/bench.rs:33-159), same
synthetic 1920x1080 ``pixel = (x*y) as u8`` image and levels=4
(bench.rs:15-31), same throughput convention (criterion's bytes/s equals
pixels/s there; reported as MPix/s):

| bench                  | reference (bench.rs) | here                         |
|------------------------|----------------------|------------------------------|
| memory                 | :38-52 memcpy ceiling| device plane copy            |
| left_top_nop_encode    | :54-63               | LeftTop predictor, identity q|
| left_top_quanted_encode| :65-74               | LeftTop, Lossless LUT        |
| crossed_nop_encode     | :76-85               | Crossed, identity q          |
| crossed_quanted_encode | :87-96               | Crossed, Lossless LUT        |
| decode                 | :98-110              | Crossed decode               |
| serialization          | :112-127             | host container+entropy stage |
| compression            | :129-151             | e2e encode + serialize       |

The *_nop rows use the NoOp strategy (quantizator.rs:17-34 — no table at
all; the encode specializes the identity away and takes the lossless fast
path) while the *_quanted rows use the table-driven Lossless LUT
(quantizator.rs:36-73 — a real 256-entry gather per residual through the
full closed loop).  The pairs therefore measure different kernels, exactly
as the reference's pairs isolate traversal cost from LUT-lookup cost.

Device timings use the chained-dispatch slope: K dependent calls inside
one jitted ``fori_loop``, timed at two K, so dispatch overhead cancels.
Statistics are criterion-grade: sample_size timing samples per bench
(criterion uses 25, benches/bench.rs:154-157) with the median reported
and the (min, max) spread retained in ``run_suite_stats``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["run_suite", "SUITE"]

W, H, LEVELS = 1920, 1080, 4  # bench.rs:34-36


def _synthetic() -> np.ndarray:
    x = np.arange(W, dtype=np.int64)
    y = np.arange(H, dtype=np.int64)
    return ((y[:, None] * x[None, :]) & 0xFF).astype(np.uint8)


def _samples(fn: Callable[[], None], iters: int):
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return ts


def _median(fn: Callable[[], None], iters: int) -> float:
    return float(np.median(_samples(fn, iters)))


def _device_step_samples(step, x, k_lo=2, k_hi=14, iters=3):
    """Per-call device-time samples via the chained-dispatch slope.

    Returns ``iters`` independent slope samples (each from a fresh
    (K_lo, K_hi) timing pair) so callers can report median + spread.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    def chained(k):
        @jax.jit
        def f(v):
            return lax.fori_loop(0, k, lambda i, y: step(y ^ jnp.uint8(i & 1)), v)

        return f

    fns = {}
    for k in (k_lo, k_hi):
        fns[k] = chained(k)
        np.asarray(fns[k](x).ravel()[:1])  # compile + warm
    samples = []
    for _ in range(iters):
        t_lo = _median(lambda: np.asarray(fns[k_lo](x).ravel()[:1]), 1)
        t_hi = _median(lambda: np.asarray(fns[k_hi](x).ravel()[:1]), 1)
        samples.append((t_hi - t_lo) / (k_hi - k_lo))
    return samples


def _device_step_seconds(step, x, k_lo=2, k_hi=14, iters=3) -> float:
    return float(np.median(_device_step_samples(step, x, k_lo, k_hi, iters)))


def _stat(times, npix) -> Dict[str, float]:
    """Throughput stats from per-call time samples (spread = min..max)."""
    times = np.asarray(times, dtype=np.float64)
    times = times[times > 0]  # a contention spike can corrupt one slope
    if times.size == 0:
        return {"mpix_s": 0.0, "mpix_s_min": 0.0, "mpix_s_max": 0.0}
    tput = npix / times / 1e6
    return {
        "mpix_s": float(np.median(tput)),
        "mpix_s_min": float(tput.min()),
        "mpix_s_max": float(tput.max()),
    }


def run_suite_stats(
    device: bool = True, batch: int = 8, samples: int = 25
) -> Dict[str, Dict[str, float]]:
    """Run the full suite with criterion-grade statistics.

    Returns ``{bench: {mpix_s, mpix_s_min, mpix_s_max}}`` from
    ``samples`` timing samples per bench (criterion's sample_size=25,
    benches/bench.rs:154-157).  Serialization/compression are measured on
    one plane, device benches on a batch.
    """
    import jax
    import jax.numpy as jnp

    from ..models.codec import HGICodec
    from ..ops import pyramid
    from ..ops.predictors import predictor_fn
    from ..ops.quantizers import QuantizationLevel, quantize_fn
    from ..utils.container import Archive, write_hgi

    image = _synthetic()
    planes = jnp.asarray(np.broadcast_to(image, (batch, H, W)).copy())
    npix = batch * W * H
    # Device slopes need 2 timing runs per sample; split the budget.
    dev_iters = max(3, samples // 2)
    results: Dict[str, Dict[str, float]] = {}

    # memory: device plane copy ceiling (bench.rs:38-52 is host memcpy).
    ts = _device_step_samples(lambda v: v + jnp.uint8(1), planes, iters=dev_iters)
    results["memory"] = _stat(ts, npix)

    # *_nop: NoOp strategy (no table; lossless fast path).  *_quanted:
    # table-driven Lossless LUT (real 256-entry gather, full closed loop).
    combos = {
        "left_top_nop_encode": ("left_top", "noop"),
        "left_top_quanted_encode": ("left_top", "lut"),
        "crossed_nop_encode": ("crossed", "noop"),
        "crossed_quanted_encode": ("crossed", "lut"),
    }
    for name, (pred_name, strategy) in combos.items():
        pred = predictor_fn(pred_name)
        quant = quantize_fn(QuantizationLevel.LOSSLESS, strategy)

        def step(v, quant=quant, pred=pred):
            g, r = pyramid.encode_plane(v, LEVELS, quant, pred)
            return g ^ r

        ts = _device_step_samples(step, planes, iters=dev_iters)
        results[name] = _stat(ts, npix)

    ts = _device_step_samples(
        lambda v: pyramid.decode_plane(v, LEVELS), planes, iters=dev_iters
    )
    results["decode"] = _stat(ts, npix)

    # serialization: host container+entropy stage on one encoded plane.
    codec = HGICodec(LEVELS, QuantizationLevel.LOSSLESS)
    archive = codec.encode(image)
    write_hgi(archive)  # warm
    ts = _samples(lambda: write_hgi(archive), samples)
    results["serialization"] = _stat(ts, W * H)

    # compression: end-to-end encode + serialize of one plane (bench.rs:129).
    def e2e():
        write_hgi(codec.encode(image))

    e2e()
    ts = _samples(e2e, samples)
    results["compression"] = _stat(ts, W * H)
    return results


def run_suite(device: bool = True, batch: int = 8) -> Dict[str, float]:
    """Median-only view of :func:`run_suite_stats` ({bench: MPix/s})."""
    return {
        k: v["mpix_s"]
        for k, v in run_suite_stats(device=device, batch=batch).items()
    }


def format_suite(results) -> str:
    width = max(len(k) for k in results)
    lines = []
    for k, v in results.items():
        if isinstance(v, dict):
            lines.append(
                f"{k:<{width}}  {v['mpix_s']:12,.1f} MPix/s  "
                f"[{v['mpix_s_min']:,.1f} .. {v['mpix_s_max']:,.1f}]"
            )
        else:
            lines.append(f"{k:<{width}}  {v:12,.1f} MPix/s")
    return "\n".join(lines)
