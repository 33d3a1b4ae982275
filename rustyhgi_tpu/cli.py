"""Command-line interface.

Mirrors the reference CLI surface (reference: src/options.rs:13-65,
src/main.rs:41-128): ``encode``/``decode``/``test`` subcommands with
``-i/-o/-l/-q/-s`` flags, same defaults (level=4, quantizator=medium,
case-insensitive), plus extras: ``--format hgi|thgi``,
``--backend jax|oracle|native``, ``--engine auto|planar|xla`` (force a
device engine; all bit-identical), tiled gigapixel encode/decode, and a
``bench`` subcommand.  Binary PGM (``.pgm``) images need only numpy;
other image formats use Pillow.

Usage::

    python -m rustyhgi_tpu encode -i in.pgm -o out.hgi -l 4 -q medium
    python -m rustyhgi_tpu decode -i out.hgi -o roundtrip.pgm
    python -m rustyhgi_tpu test in.pgm -l 4 -q lossless
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .models.codec import HGICodec
from .ops.engine import ENGINES
from .ops.quantizers import QuantizationLevel
from .utils.container import Archive, read_archive, write_archive
from .utils.imageio import load_luma, save_gray


def _add_encoding_options(p: argparse.ArgumentParser) -> None:
    # Defaults per options.rs:55-64.
    p.add_argument("-l", "--level", type=int, default=4, help="pyramid depth")
    p.add_argument(
        "-q",
        "--quantizator",
        type=str,
        default="medium",
        help="lossless|low|medium|high (case-insensitive)",
    )
    p.add_argument(
        "--backend",
        choices=("jax", "oracle", "native"),
        default="jax",
        help="compute backend (jax = the device engines)",
    )
    p.add_argument(
        "--engine",
        choices=ENGINES,
        default="auto",
        help="jax backend only: force a device engine (auto routes the "
        "fastest supported one; all engines are bit-identical)",
    )
    p.add_argument(
        "--format",
        choices=("hgi", "thgi"),
        default="hgi",
        help="container format (hgi = reference byte-compatible)",
    )
    p.add_argument(
        "--fast",
        action="store_true",
        help="thgi only: device-coded fast mode (device encode + "
        "lane-parallel device rANS in one program; no host entropy crunch)",
    )
    p.add_argument(
        "--predictor",
        choices=("crossed", "left_top"),
        default="crossed",
        help="interpolation predictor (tagged in the archive; decode "
        "honors the tag)",
    )
    p.add_argument(
        "--color",
        action="store_true",
        help="keep RGB (3 planes in one .thgic container; lossless uses a "
        "reversible green-delta transform) instead of the reference's "
        "luma conversion",
    )


def _make_grid(
    image: np.ndarray, levels: int, quant, backend: str,
    predictor: str = "crossed", engine: str = "auto",
):
    if backend == "jax":
        grid, _ = HGICodec(
            levels, quant, predictor=predictor, backend=engine
        ).encode_plane(image)
        return np.asarray(grid)
    if backend == "oracle":
        from .oracle import oracle_encode

        return oracle_encode(image, levels, quant, predictor=predictor)
    if backend == "native":
        if predictor != "crossed":
            from .oracle import oracle_encode

            return oracle_encode(image, levels, quant, predictor=predictor)
        from .ops.native import native_encode

        return native_encode(image, levels, quant)
    raise ValueError(backend)


def _decode_grid(
    grid: np.ndarray, levels: int, backend: str, predictor: str = "crossed",
    engine: str = "auto",
) -> np.ndarray:
    if backend == "jax":
        return np.asarray(
            HGICodec(
                levels, predictor=predictor, backend=engine
            ).decode_plane(grid)
        )
    if backend == "oracle":
        from .oracle import oracle_decode

        return oracle_decode(grid, levels, predictor=predictor)
    if backend == "native":
        from .ops.native import native_decode

        if predictor != "crossed":
            # The scalar C++ twin implements Crossed only; fall back.
            from .oracle import oracle_decode

            return oracle_decode(grid, levels, predictor=predictor)
        return native_decode(grid, levels)
    raise ValueError(backend)


def _serialize(archive: Archive, args) -> bytes:
    if args.format == "thgi" and getattr(args, "fast", False):
        from .utils.container import write_thgi

        return write_thgi(archive, fast=True)
    return write_archive(archive, args.format)


def cmd_encode(args) -> int:
    quant = QuantizationLevel.parse(args.quantizator)
    if getattr(args, "color", False):
        from .utils.color import encode_color, load_rgb

        codec = HGICodec(
            args.level, quant, predictor=args.predictor,
            backend=getattr(args, "engine", "auto"),
        )
        blob = encode_color(codec, load_rgb(args.input), fmt=args.format)
        with open(args.output, "wb") as f:
            f.write(blob)
        return 0
    image = load_luma(args.input)
    engine = getattr(args, "engine", "auto")
    codec = HGICodec(
        args.level, quant, predictor=args.predictor, backend=engine
    )
    if args.format == "thgi" and args.fast and args.backend == "jax":
        # One fused device program (encode + device rANS); only
        # entropy-CODED bytes cross the host<->device link.
        with open(args.output, "wb") as f:
            f.write(codec.write_fast(image))
        return 0
    grid = _make_grid(
        image, args.level, quant, args.backend, predictor=args.predictor,
        engine=engine,
    )
    archive = Archive(codec.metadata_for(*image.shape), grid)
    with open(args.output, "wb") as f:
        f.write(_serialize(archive, args))
    return 0


def cmd_decode(args) -> int:
    import numpy as np

    with open(args.input, "rb") as f:
        data = f.read()
    from .utils.container import _magic

    if _magic(data) == 0x7C61_A555:  # .thgic color
        from .utils.color import decode_color, decode_color_preview, save_rgb

        if getattr(args, "preview", None) is not None:
            save_rgb(args.output, decode_color_preview(data, args.preview))
        else:
            save_rgb(args.output, decode_color(data))
        return 0
    from .ops.predictors import predictor_name_for_tag

    if getattr(args, "preview", None) is not None:
        # Progressive decode: reconstruct only the coarsest N levels ->
        # a 2**(levels-N)-downsampled preview.  Subband .thgi archives
        # entropy-decode only the payload prefix.
        from .utils.container import read_preview

        meta, anchors, subbands, upto = read_preview(data, args.preview)
        codec = HGICodec(
            meta.scale_level,
            predictor=predictor_name_for_tag(meta.interpolation),
        )
        preview = np.asarray(
            codec.decode_preview(
                anchors, subbands, (meta.height, meta.width), upto
            )
        )
        save_gray(args.output, preview)
        return 0
    if args.backend == "jax":
        # Subband-layout .thgi archives feed the device decoder directly
        # (no grid assembly, no device re-split).
        try:
            from .utils.container import read_thgi_subbands

            meta, anchors, subbands = read_thgi_subbands(data)
            codec = HGICodec(
                meta.scale_level,
                predictor=predictor_name_for_tag(meta.interpolation),
            )
            image = np.asarray(
                codec.decode_subbands(
                    anchors, subbands, (meta.height, meta.width)
                )
            )
            save_gray(args.output, image)
            return 0
        except ValueError:
            pass  # not a subband .thgi; fall through to the grid path
    archive = read_archive(data)
    image = _decode_grid(
        archive.grid,
        archive.metadata.scale_level,
        args.backend,
        predictor=predictor_name_for_tag(archive.metadata.interpolation),
    )
    save_gray(args.output, image)
    return 0


def cmd_test(args) -> int:
    # Mirrors main.rs:73-120: roundtrip, print metrics, write .png + archive.
    quant = QuantizationLevel.parse(args.quantizator)
    image = load_luma(args.input)
    engine = getattr(args, "engine", "auto")
    codec = HGICodec(args.level, quant, predictor=args.predictor)
    grid = _make_grid(
        image, args.level, quant, args.backend, predictor=args.predictor,
        engine=engine,
    )
    decoded = _decode_grid(
        grid, args.level, args.backend, predictor=args.predictor,
        engine=engine,
    )
    archive = Archive(codec.metadata_for(*image.shape), grid)
    blob = write_archive(archive, args.format)

    diff = image.astype(np.int64) - decoded.astype(np.int64)
    uncompressed = image.size
    sd = int((diff**2).sum()) // uncompressed  # integer mean, main.rs:106
    print(f"Uncompressed: {uncompressed // 1024} kb")
    print(f"Compressed:   {len(blob) // 1024} kb")
    print(f"Ratio:        {uncompressed / len(blob):.2f}")
    print(f"SD:           {float(sd) ** 0.5:.2f}")

    # The decoded image is a PNG like the reference's, or a PGM for a PGM
    # input (which keeps the command free of imaging libraries).
    root, in_ext = os.path.splitext(os.path.basename(args.input))
    stem = root + args.suffix
    save_gray(stem + (".pgm" if in_ext.lower() == ".pgm" else ".png"), decoded)
    ext = "." + args.format
    with open(stem + ext, "wb") as f:
        f.write(blob)
    return 0


def _read_thgit_prefix(path, tile, width, height):
    """Count complete blocks in an existing .thgit (resume support).

    Only v2 archives (magic 0x7161A556: u8 flags + optional shared
    table, u64 length + u32 CRC framing) are resumable — CRC-invalid
    blocks end the valid prefix.  Legacy v1 files return None (a resume
    would have to append v2 frames to v1 framing, corrupting the file;
    they re-encode from scratch instead, and stay readable through
    ``parse_thgit``).  Returns
    (n_complete_blocks, byte_offset_after_them, shared_freqs), or None
    if the file is absent or its header does not match the requested job.
    """
    import struct
    import zlib as _zlib

    import numpy as np

    from .utils.container import THGIT2_MAGIC

    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < 21:
        return None
    magic, t, w, h, n = struct.unpack_from("<IIIII", data, 0)
    if magic != THGIT2_MAGIC or (t, w, h) != (tile, width, height):
        return None
    freqs = None
    flags = data[20]
    off = 21
    if flags & 1:
        if len(data) < off + 512:
            return None
        freqs = np.frombuffer(data, dtype="<u2", count=256, offset=off).copy()
        off += 512
    k = 0
    while k < n and off + 12 <= len(data):
        blen, crc = struct.unpack_from("<QI", data, off)
        if off + 12 + blen > len(data):
            break  # trailing partial block: drop it
        if _zlib.crc32(data[off + 12 : off + 12 + blen]) != crc:
            break  # corrupt tail: rewrite from here
        off += 12 + blen
        k += 1
    return k, off, freqs


def cmd_encode_tiled(args) -> int:
    """Gigapixel path: independent per-tile streams, sharded over devices.

    Output format (.thgit v2, utils.container.thgit2_header): header with
    optional once-per-archive shared rANS table, then per block u64 LE
    length + u32 LE CRC32 + block bytes (each block a standalone
    .hgi/.thgi archive, row-major tile order).  Blocks are streamed to
    disk as they are compressed, so an interrupted job leaves a valid
    prefix; ``--resume`` continues from the first missing or
    CRC-corrupt block (per-tile restartability, SURVEY.md §5).

    ``--shared-table`` psums the global residual histogram on device and
    codes every block against one rANS table stored once in the header
    (multi-host-identical bytes; see parallel.multihost).
    """
    import sys as _sys

    import numpy as np

    from .ops.entropy import normalized_freqs
    from .parallel.mesh import make_mesh
    from .parallel.sharded import encode_batch_sharded, pad_batch, tile_plane
    from .utils.container import thgit2_block_frame, thgit2_header, write_archive

    quant = QuantizationLevel.parse(args.quantizator)
    shared = getattr(args, "shared_table", False)
    if shared and args.format != "thgi":
        raise ValueError("--shared-table requires --format thgi")
    image = load_luma(args.input)
    mesh_shape = None
    if args.mesh:
        parts = args.mesh.split(",")
        if len(parts) != 2:
            raise ValueError("--mesh expects DATA,TILE (e.g. 4,2)")
        mesh_shape = (int(parts[0]), int(parts[1]))

    tiles, _ = tile_plane(image, (args.tile, args.tile))
    n_tiles = tiles.shape[0]
    h, w = image.shape

    start = 0
    mode = "wb"
    freqs = None
    if getattr(args, "resume", False):
        prefix = _read_thgit_prefix(args.output, args.tile, w, h)
        if prefix is not None:
            start, off, freqs = prefix
            if shared and freqs is None:
                raise ValueError(
                    "--shared-table resume needs a v2 archive with a table"
                )
            if start >= n_tiles:
                return 0  # already complete
            with open(args.output, "r+b") as f:
                f.truncate(off)  # drop any trailing partial/corrupt block
            mode = "ab"
            print(f"resuming at block {start}/{n_tiles}", file=_sys.stderr)

    engine = getattr(args, "engine", "auto")
    if engine != "auto":
        # Fail fast on coverage: the sharded retry tier below retries
        # transient device errors, and a config error never succeeds.
        from .ops.engine import choose_engine
        from .ops.quantizers import quantize_fn

        choose_engine(engine, args.level, args.tile, args.tile,
                      quantize_fn(quant), args.predictor)
    codec = HGICodec(
        args.level, quant, predictor=args.predictor, backend=engine
    )
    fast = getattr(args, "fast", False)
    if fast and (args.format != "thgi" or shared):
        # Never silently degrade an explicit fast request to the host
        # entropy path (mirrors the --shared-table format check above).
        raise ValueError(
            "--fast requires --format thgi and is incompatible with "
            "--shared-table (the device coder builds per-tile tables)"
        )
    if fast:
        from .ops.tpurans import MAX_SYMBOLS

        if args.tile * args.tile > MAX_SYMBOLS:
            # write_fast_batch would silently fall back per-tile to the
            # host entropy path beyond the device coder's exact-histogram
            # envelope — the degradation --fast must never hide.
            raise ValueError(
                f"--fast tile {args.tile} exceeds the device coder's "
                f"envelope (tile*tile must be <= {MAX_SYMBOLS}); use a "
                "smaller --tile or drop --fast"
            )
    if fast:
        # Fused fast tier for the gigapixel path: each chunk of tiles is
        # ONE device program (encode + lane-parallel device rANS,
        # models.codec.write_fast_batch) and only entropy-coded bytes
        # cross the link; every block is byte-identical to write_fast on
        # that tile, so --resume and decode-tiled compose unchanged.
        remaining = tiles[start:]
        with open(args.output, mode) as f:
            if mode == "wb":
                f.write(thgit2_header(args.tile, w, h, n_tiles, None))
            chunk = 32
            for lo in range(0, remaining.shape[0], chunk):
                for b in codec.write_fast_batch(remaining[lo : lo + chunk]):
                    f.write(thgit2_block_frame(b))
                    f.flush()  # valid resumable prefix at every block
        return 0

    mesh = make_mesh(mesh_shape)
    remaining = tiles[start:]
    padded, _ = pad_batch(remaining, mesh.devices.size)

    # Failure-detection tier: one retry for transient device/runtime
    # errors before surfacing (per-tile work is idempotent).
    for attempt in (1, 2):
        try:
            grids, _, _ = encode_batch_sharded(
                padded, args.level, quant, mesh=mesh,
                predictor=args.predictor, engine=engine,
            )
            grids_host = np.asarray(grids)[: remaining.shape[0]]
            break
        except Exception as e:
            if attempt == 2:
                raise
            print(f"encode attempt failed ({e}); retrying", file=_sys.stderr)
    if shared and freqs is None:
        # The table must describe the global batch; a fresh shared run
        # always starts at tile 0 (resume reuses the header-pinned
        # table), so grids_host covers every real tile.  Zero-pad tiles
        # are excluded so the table is mesh-shape invariant.
        freqs = normalized_freqs(
            np.bincount(grids_host.reshape(-1), minlength=256)
        )

    with open(args.output, mode) as f:
        if mode == "wb":
            f.write(thgit2_header(args.tile, w, h, n_tiles, freqs))
        for i in range(remaining.shape[0]):
            archive = Archive(
                codec.metadata_for(args.tile, args.tile), grids_host[i]
            )
            b = write_archive(archive, args.format, freqs=freqs)
            f.write(thgit2_block_frame(b))
            f.flush()  # interrupted jobs leave a valid resumable prefix
    return 0


def cmd_decode_tiled(args) -> int:
    import numpy as np

    from .ops.predictors import predictor_name_for_tag
    from .parallel.sharded import untile_plane
    from .utils.container import parse_thgit

    with open(args.input, "rb") as f:
        data = f.read()
    # parse_thgit verifies per-block CRCs (v2) and surfaces the corrupt
    # block index — the failure-detection contract of the tiled tier.
    tile, width, height, blocks, freqs = parse_thgit(data)
    grids, levels, interp = [], None, 0
    for block in blocks:
        archive = read_archive(block, freqs=freqs)
        grids.append(archive.grid)
        levels = archive.metadata.scale_level
        interp = archive.metadata.interpolation
    codec = HGICodec(levels, predictor=predictor_name_for_tag(interp))
    tiles = np.asarray(codec.decode_plane(np.stack(grids)))
    save_gray(args.output, untile_plane(tiles, (height, width)))
    return 0


def cmd_bench(args) -> int:
    from .utils.benchsuite import format_suite, run_suite_stats

    results = run_suite_stats(batch=args.batch, samples=args.samples)
    print(format_suite(results))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rustyhgi_tpu",
        description="hierarchical grid interpolation image codec",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("encode", help="compress an image to an archive")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    _add_encoding_options(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help="decompress an archive to an image")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--backend", choices=("jax", "oracle", "native"), default="jax"
    )
    p.add_argument(
        "--preview",
        type=int,
        default=None,
        metavar="N",
        help="progressive decode: reconstruct only the coarsest N levels "
        "(a 2^(levels-N)-downsampled preview; subband .thgi archives "
        "entropy-decode only the payload prefix)",
    )
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("test", help="roundtrip + metrics (reference parity)")
    p.add_argument("input")
    p.add_argument("-s", "--suffix", default="")
    _add_encoding_options(p)
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser(
        "encode-tiled",
        help="tile a large image into independent streams, encode data-"
        "parallel over all devices, emit one block archive per tile",
    )
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True, help="output .thgit path")
    p.add_argument("--tile", type=int, default=512, help="square tile size")
    p.add_argument(
        "--mesh",
        type=str,
        default=None,
        help="device mesh shape as DATA,TILE (default: all devices on the"
        " data axis)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="continue an interrupted job from the first missing block",
    )
    p.add_argument(
        "--shared-table",
        action="store_true",
        help="entropy-code all blocks against one global rANS table "
        "stored once in the header (requires --format thgi)",
    )
    _add_encoding_options(p)
    p.set_defaults(fn=cmd_encode_tiled)

    p = sub.add_parser(
        "decode-tiled", help="decode a tiled archive back to an image"
    )
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_decode_tiled)

    p = sub.add_parser(
        "bench",
        help="benchmark suite mirroring the reference's criterion benches",
    )
    p.add_argument("--batch", type=int, default=8)
    p.add_argument(
        "--samples",
        type=int,
        default=25,
        help="timing samples per bench (criterion sample_size parity)",
    )
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    try:
        engine, backend = getattr(args, "engine", "auto"), getattr(args, "backend", "jax")
        if engine != "auto" and backend != "jax":
            raise ValueError(
                f"--engine {engine} applies to --backend jax only, "
                f"not --backend {backend}"
            )
        return args.fn(args)
    except Exception as e:  # main.rs:130-133 error surface
        print(f"An error occured: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
