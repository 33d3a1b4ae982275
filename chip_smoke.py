"""Run the codec's main path once on the GPU, at the sizes users process.

    python chip_smoke.py             # every single-card phase, on one card
    python chip_smoke.py --chips 4   # only the sharded phase, on four cards

Pixels come from ``--seed``: smooth gradients plus noise, and a
uniform-random plane as the worst case.  Every check is exact, because
the codec is integer-only:

* every residual grid equals the scalar C++ codec's grid
  (``ops.native.native_encode``, built from ``native/``), and at 300x500
  also ``oracle.py``'s;
* decode equals the encoder's closed-loop reconstruction; lossless decode
  equals the input; lossy max |decoded - original| is within 10/20/30.

Each phase prints one line (name, shapes, wall seconds, ``ok``).  Any
mismatch or exception ends the run with a non-zero exit code before the
result line.  The script refuses to run anywhere but on a GPU.  The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.ops.native import native_decode, native_encode
from rustyhgi_tpu.ops.quantizers import QuantizationLevel, linear_error
from rustyhgi_tpu.oracle import oracle_encode

PRESETS = list(QuantizationLevel)
LOSSLESS, MEDIUM = QuantizationLevel.LOSSLESS, QuantizationLevel.MEDIUM
FULLHD = (1080, 1920)
IKONOS = (2368, 2614)  # the reference's ikonos-barcelona-spain.jpg
RAGGED = (300, 500)
SENTINEL2 = 10980  # Sentinel-2 L1C tile edge, in pixels


class SmokeFailure(AssertionError):
    pass


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def gradient_planes(rng, n, h, w):
    """Smooth gradients plus noise: photo-like residual statistics."""
    y = np.linspace(0.0, 1.0, h)[:, None]
    x = np.linspace(0.0, 1.0, w)[None, :]
    out = np.empty((n, h, w), np.uint8)
    for i in range(n):
        a, b, c = rng.uniform(40, 200, 3)
        base = a * x + b * y + c * x * y + 20 * np.sin(6.0 * x + 4.0 * y + i)
        noise = rng.normal(0.0, 3.0, (h, w))
        out[i] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return out


def uniform_planes(rng, n, h, w):
    return rng.integers(0, 256, (n, h, w), dtype=np.uint8)


def mixed_batch(rng, n, h, w):
    """``n`` planes, the last one uniform-random (the worst case)."""
    if n == 1:
        return gradient_planes(rng, 1, h, w)
    return np.concatenate(
        [gradient_planes(rng, n - 1, h, w), uniform_planes(rng, 1, h, w)]
    )


def check_grid(grid, image, levels, preset, predictor="crossed", oracle=False):
    """Residual grid == the scalar C++ codec's (and the oracle's)."""
    grid = np.asarray(grid)
    if predictor == "crossed":
        want = native_encode(image, levels, preset)
        require(np.array_equal(grid, want),
                f"grid != native_encode ({image.shape}, L{levels}, {preset.name})")
    if oracle:
        want = oracle_encode(image, levels, preset, predictor)
        require(np.array_equal(grid, want),
                f"grid != oracle ({image.shape}, L{levels}, {preset.name}, "
                f"{predictor})")


def check_decode(decoded, recon, image, preset):
    """Decode == closed-loop recon; error vs the original within the bound."""
    decoded, recon = np.asarray(decoded), np.asarray(recon)
    require(np.array_equal(decoded, recon), "decode != closed-loop recon")
    err = int(np.abs(decoded.astype(np.int16) - image.astype(np.int16)).max())
    require(err <= linear_error(preset),
            f"max |decoded - original| {err} > {linear_error(preset)}")


def roundtrip(codec, images, levels, preset, predictor="crossed", oracle=False):
    """Encode + decode a [B, H, W] batch through HGICodec and check it."""
    grids, recons = codec.encode_plane(images)
    decoded = codec.decode_plane(grids)
    grids, recons = np.asarray(grids), np.asarray(recons)
    for i in range(images.shape[0]):
        check_grid(grids[i], images[i], levels, preset, predictor, oracle)
    check_decode(decoded, recons, images, preset)


# -- phases ---------------------------------------------------------------------


def phase_grid_fullhd(rng, hw=FULLHD, batch=8):
    """1920x1080, batch 1 and batch 8, every preset, Crossed, L4."""
    for preset in PRESETS:
        codec = HGICodec(4, preset)
        for n in (1, batch):
            roundtrip(codec, mixed_batch(rng, n, *hw), 4, preset)
    return f"[1|{batch}]x{hw[0]}x{hw[1]} L4 x{len(PRESETS)} presets"


def phase_grid_levels(rng, hw=IKONOS, levels=range(1, 9)):
    """The reference's ikonos size, every depth, lossless and medium."""
    image = gradient_planes(rng, 1, *hw)
    for preset in (LOSSLESS, MEDIUM):
        for lv in levels:
            roundtrip(HGICodec(lv, preset), image, lv, preset)
    return f"1x{hw[0]}x{hw[1]} L{min(levels)}-{max(levels)} lossless+medium"


def phase_grid_ragged(rng, hw=RAGGED):
    """A ragged plane with both predictors, checked against the oracle."""
    images = mixed_batch(rng, 2, *hw)
    for predictor in ("crossed", "left_top"):
        for preset in PRESETS:
            codec = HGICodec(4, preset, predictor=predictor)
            roundtrip(codec, images, 4, preset, predictor, oracle=True)
    return f"2x{hw[0]}x{hw[1]} L4 x{len(PRESETS)} presets crossed+left_top"


def phase_subband_preview(rng, hw=FULLHD, levels=4):
    """Subband encode -> subband-direct decode, and progressive preview."""
    from rustyhgi_tpu.utils.container import assemble_grid_np

    image = gradient_planes(rng, 1, *hw)[0]
    codec = HGICodec(levels, MEDIUM)
    anchors, subbands, recon = codec.encode_subbands(image)
    anchors_np = np.asarray(anchors)
    subbands_np = [tuple(np.asarray(q) for q in quads) for quads in subbands]
    grid = assemble_grid_np(anchors_np, subbands_np, *hw, levels)
    check_grid(grid, image, levels, MEDIUM)
    decoded = codec.decode_subbands(anchors, subbands, hw)
    check_decode(decoded, recon, image, MEDIUM)
    full = np.asarray(decoded)
    for upto in range(levels + 1):
        s = 1 << (levels - upto)
        preview = np.asarray(codec.decode_preview(anchors, subbands, hw, upto))
        require(np.array_equal(preview, full[::s, ::s]),
                f"preview upto={upto} != decoded[::{s}, ::{s}]")
    return f"1x{hw[0]}x{hw[1]} L{levels} medium, previews 0-{levels}"


def phase_write_fast(rng, hw=FULLHD, batch=8, levels=4):
    """write_fast and write_fast_batch, read back with read_thgi."""
    import jax

    from rustyhgi_tpu.utils.container import read_thgi

    images = mixed_batch(rng, batch, *hw)
    notes = []
    for preset in (LOSSLESS, MEDIUM):
        codec = HGICodec(levels, preset)
        _, recons = codec.encode_plane(images)
        recons = np.asarray(recons)
        # Twice: the first call fetches a full-size prefix, the second
        # one sized by the first call's estimate.
        for _ in range(2):
            blobs = [codec.write_fast(images[0])]
            blobs += codec.write_fast_batch(images)
        for i, blob in enumerate(blobs):
            k = max(i - 1, 0)
            archive = read_thgi(blob)
            check_grid(archive.grid, images[k], levels, preset)
            check_decode(codec.decode(archive), recons[k], images[k], preset)
        require(blobs[0] == blobs[1], "write_fast != write_fast_batch[0]")
        # The device-built frequency table divides in float32, so the bytes
        # may differ from the CPU backend's; decoding exactly is the contract.
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:
            notes.append(f"{preset.name.lower()} cpu_bytes_match=n/a")
            continue
        with jax.default_device(cpu):
            cpu_blob = HGICodec(levels, preset).write_fast(images[0])
        notes.append(f"{preset.name.lower()} cpu_bytes_match={cpu_blob == blobs[0]}")
    return f"[1|{batch}]x{hw[0]}x{hw[1]} L{levels} lossless+medium, " + ", ".join(notes)


def phase_containers(rng, hw=FULLHD, levels=4):
    """.hgi and .thgi round trips through write_archive/read_archive."""
    from rustyhgi_tpu.utils.container import read_archive, write_archive

    image = gradient_planes(rng, 1, *hw)[0]
    sizes = []
    for preset in (LOSSLESS, MEDIUM):
        codec = HGICodec(levels, preset)
        archive = codec.encode(image)
        check_grid(archive.grid, image, levels, preset)
        for fmt in ("hgi", "thgi"):
            blob = write_archive(archive, fmt)
            back = read_archive(blob)
            require(np.array_equal(back.grid, archive.grid), f"{fmt} grid")
            require(back.metadata == archive.metadata, f"{fmt} metadata")
            decoded = codec.decode(back)
            require(np.array_equal(decoded, native_decode(archive.grid, levels)),
                    f"{fmt} decode != native_decode")
            check_decode(decoded, decoded, image, preset)
            sizes.append(f"{fmt}/{preset.name.lower()}={len(blob)}B")
    return f"1x{hw[0]}x{hw[1]} L{levels} " + " ".join(sizes)


def _cli(*argv):
    from rustyhgi_tpu.cli import main

    # `test` prints its metrics; keep standard output for phase lines.
    with contextlib.redirect_stdout(sys.stderr):
        rc = main([str(a) for a in argv])
    require(rc == 0, f"cli {' '.join(map(str, argv))} exited {rc}")


def phase_cli(rng, hw=FULLHD, levels=4):
    """encode, decode and test on a .pgm input, in-process."""
    from rustyhgi_tpu.utils.container import read_archive
    from rustyhgi_tpu.utils.imageio import load_luma, save_gray

    image = gradient_planes(rng, 1, *hw)[0]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.pgm")
        arc = os.path.join(tmp, "in.hgi")
        out = os.path.join(tmp, "out.pgm")
        save_gray(src, image)
        _cli("encode", "-i", src, "-o", arc, "-l", levels, "-q", "medium")
        with open(arc, "rb") as f:
            check_grid(read_archive(f.read()).grid, image, levels, MEDIUM)
        _cli("decode", "-i", arc, "-o", out)
        decoded = load_luma(out)
        check_decode(decoded, native_decode(native_encode(image, levels, MEDIUM),
                                            levels), image, MEDIUM)
        cwd = os.getcwd()
        os.chdir(tmp)  # `test` writes its outputs beside the caller
        try:
            _cli("test", src, "-l", levels, "-q", "lossless", "-s", "_rt")
        finally:
            os.chdir(cwd)
        require(np.array_equal(load_luma(os.path.join(tmp, "in_rt.pgm")), image),
                "cli test: lossless decode != input")
    return f"1x{hw[0]}x{hw[1]} L{levels} encode/decode medium, test lossless"


def phase_cli_tiled(rng, edge=SENTINEL2, tile=512, levels=4):
    """encode-tiled --fast and decode-tiled on a Sentinel-2-sized plane."""
    from rustyhgi_tpu.parallel.sharded import tile_plane
    from rustyhgi_tpu.utils.container import parse_thgit, read_archive
    from rustyhgi_tpu.utils.imageio import load_luma, save_gray

    image = gradient_planes(rng, 1, edge, edge)[0]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "scene.pgm")
        arc = os.path.join(tmp, "scene.thgit")
        out = os.path.join(tmp, "scene_out.pgm")
        save_gray(src, image)
        _cli("encode-tiled", "-i", src, "-o", arc, "--tile", tile, "-l", levels,
             "-q", "lossless", "--format", "thgi", "--fast")
        _cli("decode-tiled", "-i", arc, "-o", out)
        require(np.array_equal(load_luma(out), image),
                "decode-tiled != input (lossless)")
        with open(arc, "rb") as f:
            _, _, _, blocks, freqs = parse_thgit(f.read())
        tiles, _ = tile_plane(image, (tile, tile))
        require(len(blocks) == tiles.shape[0], "tile count")
        for block, t in zip(blocks, tiles):
            check_grid(read_archive(block, freqs=freqs).grid, t, levels, LOSSLESS)
    return (f"1x{edge}x{edge} as {tiles.shape[0]} tiles of {tile}x{tile}, "
            f"L{levels} lossless --fast")


def phase_sharded(rng, devices, hw=FULLHD, batch=8, levels=4):
    """The sharded tier over (n,1) and (n/2,2) meshes vs one-card HGICodec."""
    import jax

    from rustyhgi_tpu.parallel.mesh import make_mesh
    from rustyhgi_tpu.parallel.sharded import (
        decode_batch_sharded,
        decode_subbands_batch_sharded,
        encode_batch_sharded,
        encode_subbands_batch_sharded,
    )
    from rustyhgi_tpu.utils.container import assemble_grid_np

    n = len(devices)
    meshes = [(n, 1), (n // 2, 2)] if n % 2 == 0 else [(n, 1)]
    images = mixed_batch(rng, batch, *hw)
    for preset in (LOSSLESS, MEDIUM):
        with jax.default_device(devices[0]):
            grids1, recons1 = HGICodec(levels, preset).encode_plane(images)
        grids1, recons1 = np.asarray(grids1), np.asarray(recons1)
        for i in range(batch):
            check_grid(grids1[i], images[i], levels, preset)
        for shape in meshes:
            mesh = make_mesh(shape, devices)
            grids, recons, hist = encode_batch_sharded(
                images, levels, preset, mesh=mesh, with_histogram=True
            )
            require(np.array_equal(np.asarray(grids), grids1),
                    f"sharded grids {shape} != one-card grids")
            require(np.array_equal(np.asarray(recons), recons1),
                    f"sharded recon {shape} != one-card recon")
            require(int(np.asarray(hist).sum()) == images.size,
                    f"psum'd histogram {shape} does not sum to the pixel count")
            require(np.array_equal(
                np.asarray(hist), np.bincount(grids1.reshape(-1), minlength=256)
            ), f"psum'd histogram {shape} != host histogram")
            decoded = decode_batch_sharded(grids, levels, mesh=mesh)
            check_decode(decoded, recons1, images, preset)
            a, s = encode_subbands_batch_sharded(images, levels, preset, mesh=mesh)
            a_np = np.asarray(a)
            s_np = [tuple(np.asarray(q) for q in quads) for quads in s]
            for i in range(batch):
                g = assemble_grid_np(a_np[i], [tuple(q[i] for q in quads)
                                               for quads in s_np], *hw, levels)
                require(np.array_equal(g, grids1[i]),
                        f"sharded subbands {shape} plane {i} != one-card grid")
            dec = decode_subbands_batch_sharded(a, s, hw, levels, mesh=mesh)
            check_decode(dec, recons1, images, preset)
    return (f"{batch}x{hw[0]}x{hw[1]} L{levels} lossless+medium over meshes "
            f"{' '.join(f'({a},{b})' for a, b in meshes)} on {n} devices")


SINGLE_CARD_PHASES = (
    ("grid_fullhd", phase_grid_fullhd),
    ("grid_levels", phase_grid_levels),
    ("grid_ragged", phase_grid_ragged),
    ("subband_preview", phase_subband_preview),
    ("write_fast", phase_write_fast),
    ("containers", phase_containers),
    ("cli", phase_cli),
    ("cli_tiled", phase_cli_tiled),
)


def run_phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    shapes = fn(*args, **kwargs)
    wall = time.perf_counter() - t0
    print(f"phase={name} shapes=[{shapes}] wall_s={wall:.3f} ok", flush=True)
    return wall


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1,
                        help="4: run only the sharded phase, on four cards")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import jax

    from rustyhgi_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "refusing to run", file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"JAX found {len(devices)}", file=sys.stderr)
        return 2
    devices = devices[: args.chips]
    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)

    rng = np.random.default_rng(args.seed)
    if args.chips == 4:
        run_phase("sharded", phase_sharded, rng, devices)
    else:
        with jax.default_device(devices[0]):
            for name, fn in SINGLE_CARD_PHASES:
                run_phase(name, fn, rng)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
