"""Engine measurements on the GPU.

    python bench.py [--out chiprun_out/bench.json]

Refuses to run without a GPU: a number taken on the CPU is never
reported as a device number.  What it measures, at 1920x1080 (the
reference's criterion bench size, benches/bench.rs:15-31) with images
made from a seed (smooth gradients plus noise):

* ``engines`` — the planar engine (ops.planar) against the dyadic engine
  (ops.pyramid) for grid encode, subband encode, grid decode and subband
  decode, at batch 1 and 8, lossless and medium: host wall time per call
  around ``block_until_ready`` on device-resident inputs (median and p90
  of ``--iters`` calls after a warm-up call that compiles), and device
  time and kernel count per call from a ``jax.profiler`` trace;
* ``floor`` — the planar lossless L4 grid encode of 8 planes against its
  HBM floor (1 byte read + 1 byte written per pixel at the card's
  bandwidth), with the device time and the number of device kernels per
  call taken from a ``jax.profiler`` trace, beside an elementwise pass
  over the same batch and over 1 GiB;
* ``levels`` — ``HGICodec`` lossless encode of the reference's ikonos
  photo at levels 1-8.  It needs the reference repository's res/ images
  (``HGI_REFERENCE_RES``); without them the part is recorded as skipped,
  with the reason.

Every result carries the device kind and ``nvidia-smi``'s name and power
limit.  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Device-memory bandwidth by jax ``device_kind`` (NVIDIA data sheets:
# H100 SXM5 80 GB 3.35 TB/s, H100 PCIe 80 GB 2.0 TB/s, H100 NVL 94 GB
# 3.9 TB/s).  A device that is not listed is an error, not a default.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

H, W, LEVELS = 1080, 1920, 4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gradient_planes(seed, n, h=H, w=W):
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    out = np.empty((n, h, w), np.uint8)
    for i in range(n):
        a, b, c = rng.uniform(40, 200, 3)
        base = a * x + b * y + c * x * y + 20 * np.sin(6.0 * x + 4.0 * y + i)
        out[i] = np.clip(base + rng.normal(0.0, 3.0, (h, w)), 0, 255)
    return out


def wall_per_call(fn, args, iters):
    """(median, p90) host seconds per call; the first call compiles."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.percentile(ts, 90))


def trace_kernels(fn, args, calls=5):
    """Device kernels of ``calls`` calls: (kernels/call, device s/call, names).

    Device time is the summed duration of the kernel events on the GPU's
    stream lines of a ``jax.profiler`` trace.
    """
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            for _ in range(calls):
                jax.block_until_ready(fn(*args))
        (path,) = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"), recursive=True)
        data = ProfileData.from_file(path)
        count, total, names, lines = 0, 0, {}, set()
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                lines.add(line.name)
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    count += 1
                    total += ev.duration_ns
                    names[ev.name] = names.get(ev.name, 0) + 1
    if not count:
        raise RuntimeError(f"no kernel events on GPU stream lines {sorted(lines)}")
    return count / calls, total * 1e-9 / calls, sorted(names)


def measure(fn, args, iters):
    """Wall time per call (median, p90) and device time per call (trace)."""
    med, p90 = wall_per_call(fn, args, iters)
    kernels, device_s, _ = trace_kernels(fn, args)
    return {"median_s": med, "p90_s": p90, "device_s": device_s,
            "kernels_per_call": kernels}


def engine_fns(engine, op, preset, hw=(H, W)):
    """The jitted program of one engine/op/preset."""
    import jax

    from rustyhgi_tpu.ops import planar, pyramid
    from rustyhgi_tpu.ops.quantizers import quantize_fn

    q = quantize_fn(preset)
    if op == "grid_encode":
        if engine == "planar":
            return jax.jit(lambda x: planar.encode_plane_planar(x, LEVELS, q))
        return jax.jit(jax.vmap(lambda x: pyramid.encode_plane(x, LEVELS, q)))
    if op == "subband_encode":
        if engine == "planar":
            return jax.jit(lambda x: planar.encode_subbands_planar(x, LEVELS, q))
        return jax.jit(jax.vmap(lambda x: pyramid.encode_subbands(x, LEVELS, q)))
    if op == "grid_decode":
        if engine == "planar":
            return jax.jit(lambda g: planar.decode_plane_planar(g, LEVELS))
        return jax.jit(jax.vmap(lambda g: pyramid.decode_plane(g, LEVELS)))
    if engine == "planar":
        return jax.jit(
            lambda a, s: planar.decode_subbands_planar(a, s, hw, LEVELS)
        )
    return jax.jit(jax.vmap(
        lambda a, s: pyramid.decode_subbands(a, s, hw, LEVELS)
    ))


def measure_engines(iters, shapes=((H, W),), batches=(1, 8)):
    import jax
    import jax.numpy as jnp

    from rustyhgi_tpu.ops import planar
    from rustyhgi_tpu.ops.quantizers import QuantizationLevel, quantize_fn

    rows = []
    for (h, w), batch in [(hw, b) for hw in shapes for b in batches]:
        images = jnp.asarray(gradient_planes(batch, batch, h, w))
        for preset in (QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM):
            q = quantize_fn(preset)
            grids, _ = planar.encode_plane_planar(images, LEVELS, q)
            anchors, subbands, _ = planar.encode_subbands_planar(images, LEVELS, q)
            inputs = {
                "grid_encode": (images,),
                "subband_encode": (images,),
                "grid_decode": (grids,),
                "subband_decode": (anchors, subbands),
            }
            for op, args in inputs.items():
                for engine in ("planar", "xla"):
                    fn = engine_fns(engine, op, preset, (h, w))
                    row = measure(fn, args, iters)
                    rows.append({
                        "op": op, "engine": engine, "shape": [h, w],
                        "batch": batch, "preset": preset.name.lower(), **row,
                        "device_mpix_s": batch * h * w / row["device_s"] / 1e6,
                    })
                    log(json.dumps(rows[-1]))
        jax.clear_caches()
    return rows


def measure_floor(bandwidth):
    import jax
    import jax.numpy as jnp

    from rustyhgi_tpu.ops import planar
    from rustyhgi_tpu.ops.quantizers import QuantizationLevel, quantize_fn

    images = jnp.asarray(gradient_planes(8, 8))
    q = quantize_fn(QuantizationLevel.LOSSLESS)
    fn = jax.jit(lambda x: planar.encode_plane_planar(x, LEVELS, q)[0])
    kernels, device_s, names = trace_kernels(fn, (images,))
    wall, _ = wall_per_call(fn, (images,), 50)
    floor_s = 2 * images.size / bandwidth
    # Same-call references: an elementwise pass over the same batch (the
    # least a program touching every pixel costs, host overhead included)
    # and over 1 GiB (what the card's memory really delivers).
    flip = jax.jit(lambda x: x ^ jnp.uint8(1))
    same = measure(flip, (images,), 50)
    big = jnp.zeros((1 << 30,), jnp.uint8)
    copy = measure(flip, (big,), 20)
    row = {
        "op": "grid_encode", "engine": "planar", "batch": 8,
        "preset": "lossless", "kernels_per_call": kernels,
        "device_s": device_s, "wall_s": wall, "hbm_floor_s": floor_s,
        "floor_share": floor_s / device_s if device_s else None,
        "kernel_names": names,
        "xor_pass_same_batch": same,
        "xor_pass_1gib": {**copy, "bytes_per_s": 2 * big.size / copy["device_s"]},
    }
    log(json.dumps(row))
    return row


IKONOS = "ikonos-barcelona-spain.jpg"


def measure_levels(iters):
    from rustyhgi_tpu.models.codec import HGICodec
    from rustyhgi_tpu.utils.imageio import load_luma

    root = os.environ.get("HGI_REFERENCE_RES")
    path = os.path.join(root, IKONOS) if root else None
    if path is None or not os.path.exists(path):
        reason = f"needs the reference's res/{IKONOS} (set HGI_REFERENCE_RES)"
        log(f"levels: skipped: {reason}")
        return {"skipped": reason}
    import jax.numpy as jnp

    image = jnp.asarray(load_luma(path))
    rows = []
    for levels in range(1, 9):
        codec = HGICodec(levels, "lossless")
        row = measure(lambda x, c=codec: c.encode_plane(x), (image,), iters)
        rows.append({"levels": levels, "shape": list(image.shape), **row})
        log(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--out", default=None, help="also write the JSON here")
    parser.add_argument("--only", choices=("engines", "floor", "levels"),
                        action="append", help="measure only these parts")
    parser.add_argument("--shapes", default=f"{H}x{W}",
                        help="engines: comma-separated HxW plane shapes")
    parser.add_argument("--batches", default="1,8",
                        help="engines: comma-separated batch sizes")
    args = parser.parse_args(argv)

    import jax

    from rustyhgi_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: no GPU (JAX found {dev.platform}); refusing to run")
        return 2
    if dev.device_kind not in HBM_BYTES_PER_S:
        log(f"bench: no bandwidth entry for {dev.device_kind!r}; add it")
        return 2
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {dev.device_kind} | nvidia-smi: {smi}")

    parts = args.only or ["engines", "floor", "levels"]
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices()), "nvidia_smi": smi}}
    if "engines" in parts:
        shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
        batches = [int(b) for b in args.batches.split(",")]
        result["engines"] = measure_engines(args.iters, shapes, batches)
    if "floor" in parts:
        result["floor"] = measure_floor(HBM_BYTES_PER_S[dev.device_kind])
    if "levels" in parts:
        result["levels"] = measure_levels(args.iters)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
