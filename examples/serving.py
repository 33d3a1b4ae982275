"""Worked examples: the seven production usage patterns.

Run on CPU (JAX_PLATFORMS=cpu) or a GPU; every section is self-contained.

    PYTHONPATH=. python examples/serving.py
"""

import os
import sys

platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# Site plugins may override jax_platforms in config; make the env win.
jax.config.update("jax_platforms", platforms)

import numpy as np

import rustyhgi_tpu as hgi


def section(title):
    print(f"\n=== {title}")


def main():
    rng = np.random.default_rng(0)
    image = (np.add.outer(np.arange(512), np.arange(768)) % 256).astype(
        np.uint8
    )

    section("1. Single-plane encode/decode with warm-started executables")
    codec = hgi.HGICodec(levels=4, quantization="medium").compile(image.shape)
    archive = codec.encode(image)  # no compile cost after warmup
    blob = hgi.write_archive(archive, "thgi")
    decoded = codec.decode(hgi.read_archive(blob))
    err = np.abs(image.astype(int) - decoded.astype(int)).max()
    print(f"{image.shape} -> {len(blob)} bytes, max err {err} (bound 20)")

    section("2. Subband fast path (encode-only pipelines)")
    anchors, subbands, _ = codec.encode_subbands(image)
    rt = np.asarray(codec.decode_subbands(anchors, subbands, image.shape))
    print("subband roundtrip max err:",
          np.abs(image.astype(int) - rt.astype(int)).max())

    section("3. Shipped artifacts (no source / no retracing at serve time)")
    enc_artifact = codec.export_encoder(image.shape)
    serve_encode = hgi.models.codec.load_exported(enc_artifact)
    grid, _ = serve_encode(image)
    print(f"artifact: {len(enc_artifact)} bytes; grid {np.asarray(grid).shape}")

    section("4. Progressive preview (prefix decode)")
    from rustyhgi_tpu.utils.container import read_thgi_preview

    meta, anchors_pv, sub_pv, upto = read_thgi_preview(blob, 2)
    pv = np.asarray(
        codec.decode_preview(anchors_pv, sub_pv, (meta.height, meta.width), upto)
    )
    s = 1 << (meta.scale_level - upto)
    print(f"level-{upto} preview {pv.shape} == full[::{s}, ::{s}]:",
          np.array_equal(pv, decoded[::s, ::s]))

    section("5. Fastest encode-to-archive (fused device encode + device rANS)")
    fast_blob = codec.write_fast(image)
    fast_back = hgi.read_archive(fast_blob)
    print(f"write_fast: {len(fast_blob)} bytes; grid matches:",
          np.array_equal(fast_back.grid, archive.grid))

    section("6. Color (RGB) encode with reversible green-delta transform")
    from rustyhgi_tpu.utils.color import decode_color, encode_color

    rgb = np.stack([image, image // 2 + 7, image // 3 + 11], axis=2)
    cblob = encode_color(hgi.HGICodec(4, "lossless"), rgb)
    print(f"{rgb.shape} -> {len(cblob)} bytes; lossless exact:",
          np.array_equal(decode_color(cblob), rgb))

    section("7. Batched data-parallel encode over all devices")
    from rustyhgi_tpu.parallel import (
        encode_batch_sharded, make_mesh, pad_batch, tile_plane, untile_plane,
    )

    big = rng.integers(0, 256, (1200, 1600), np.uint8)
    tiles, shape = tile_plane(big, (512, 512))
    mesh = make_mesh()
    padded, _ = pad_batch(tiles, mesh.devices.size)
    grids, recons, _ = encode_batch_sharded(
        padded, 4, hgi.QuantizationLevel.LOSSLESS, mesh=mesh
    )
    back = untile_plane(np.asarray(recons)[: tiles.shape[0]], shape)
    print(f"{big.shape} via {tiles.shape[0]} tiles on "
          f"{mesh.devices.size} device(s): lossless exact ="
          f" {np.array_equal(back, big)}")


if __name__ == "__main__":
    main()
