"""CLI surface tests (reference parity: options.rs:13-65, main.rs:41-128)."""

import os

import numpy as np
import pytest

from rustyhgi_tpu.cli import main
from rustyhgi_tpu.utils.imageio import load_luma, save_gray

from conftest import synthetic_image


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def png(workdir):
    path = str(workdir / "img.png")
    save_gray(path, synthetic_image(40, 24))
    return path


def test_encode_decode_roundtrip(workdir, png):
    assert main(["encode", "-i", png, "-o", "a.hgi", "-q", "lossless"]) == 0
    assert main(["decode", "-i", "a.hgi", "-o", "b.png"]) == 0
    assert np.array_equal(load_luma("b.png"), synthetic_image(40, 24))


def test_lossy_flags_and_defaults(workdir, png):
    # default level=4, quantizator=medium, case-insensitive (options.rs:55-64)
    assert main(["encode", "-i", png, "-o", "m.hgi", "-q", "MeDiUm"]) == 0
    assert main(["decode", "-i", "m.hgi", "-o", "m.png"]) == 0
    err = np.abs(
        load_luma("m.png").astype(int) - synthetic_image(40, 24).astype(int)
    )
    assert err.max() <= 20


def test_test_subcommand_outputs(workdir, png, capsys):
    assert main(["test", png, "-q", "lossless", "-s", "_t"]) == 0
    out = capsys.readouterr().out
    for field in ("Uncompressed:", "Compressed:", "Ratio:", "SD:"):
        assert field in out
    assert "SD:           0.00" in out
    assert os.path.exists("img_t.png")
    assert os.path.exists("img_t.hgi")


def test_test_subcommand_honors_predictor(workdir, png, capsys):
    # Regression: cmd_test must decode with the SAME predictor it encoded
    # with — a left_top lossless roundtrip has SD exactly 0.00.
    assert main(
        ["test", png, "-q", "lossless", "-s", "_lt", "--predictor", "left_top"]
    ) == 0
    out = capsys.readouterr().out
    assert "SD:           0.00" in out


def test_error_paths(workdir, png, capsys):
    with open("junk.bin", "wb") as f:
        f.write(b"\x01" * 64)
    assert main(["decode", "-i", "junk.bin", "-o", "x.png"]) == 1
    assert "magic" in capsys.readouterr().err
    assert main(["encode", "-i", png, "-o", "x.hgi", "-q", "nope"]) == 1
    assert "quantization" in capsys.readouterr().err


def test_backend_parity(workdir, png):
    for backend in ("jax", "oracle", "native"):
        try:
            rc = main(
                ["encode", "-i", png, "-o", f"{backend}.hgi", "-q", "low",
                 "--backend", backend]
            )
        except Exception:
            if backend == "native":
                pytest.skip("native library not built")
            raise
        assert rc == 0
    jax_bytes = open("jax.hgi", "rb").read()
    oracle_bytes = open("oracle.hgi", "rb").read()
    assert jax_bytes == oracle_bytes
    if os.path.exists("native.hgi"):
        assert open("native.hgi", "rb").read() == jax_bytes


def test_tiled_roundtrip(workdir, png):
    assert main(
        ["encode-tiled", "-i", png, "-o", "t.thgit", "--tile", "16",
         "-q", "lossless", "--format", "thgi"]
    ) == 0
    assert main(["decode-tiled", "-i", "t.thgit", "-o", "t.png"]) == 0
    assert np.array_equal(load_luma("t.png"), synthetic_image(40, 24))


def test_profiling_utils():
    from rustyhgi_tpu.utils.profiling import StageTimer, codec_metrics, psnr

    a = synthetic_image(16, 16)
    m = codec_metrics(a, a, 100)
    assert m["sd"] == 0.0 and m["psnr_db"] == float("inf")
    b = a.copy()
    b[0, 0] ^= 255
    assert codec_metrics(a, b, 100)["max_error"] == 255
    assert 0 < psnr(a, b) < 100

    t = StageTimer()
    with t.stage("encode", items=a.size):
        pass
    assert "encode" in t.report()
    assert "encode" in str(t)


def test_tiled_mesh_flag(workdir, png):
    assert main(
        ["encode-tiled", "-i", png, "-o", "tm.thgit", "--tile", "16",
         "-q", "lossless", "--mesh", "4,2"]
    ) == 0
    assert main(["decode-tiled", "-i", "tm.thgit", "-o", "tm.png"]) == 0
    assert np.array_equal(load_luma("tm.png"), synthetic_image(40, 24))


def test_codec_compile_warmup():
    from rustyhgi_tpu.models.codec import HGICodec

    c = HGICodec(3, "medium").compile((16, 16), (24, 40))
    img = synthetic_image(40, 24)  # synthetic_image(w, h) -> [h, w]
    grid, _ = c.encode_plane(img)
    assert grid.shape == (24, 40)


def test_tiled_resume(workdir, png):
    import struct

    # Full run, then truncate to a partial prefix and resume (v2 framing:
    # u8 flags header byte, u64 length + u32 CRC per block).
    assert main(
        ["encode-tiled", "-i", png, "-o", "r.thgit", "--tile", "16",
         "-q", "lossless"]
    ) == 0
    full = open("r.thgit", "rb").read()
    # keep header + first 2 complete blocks (+ a garbage partial tail)
    off, k = 21, 0
    while k < 2:
        (blen,) = struct.unpack_from("<Q", full, off)
        off += 12 + blen
        k += 1
    open("r.thgit", "wb").write(full[:off] + b"\x07\x07\x07")
    assert main(
        ["encode-tiled", "-i", png, "-o", "r.thgit", "--tile", "16",
         "-q", "lossless", "--resume"]
    ) == 0
    assert open("r.thgit", "rb").read() == full
    # resuming a complete file is a no-op
    assert main(
        ["encode-tiled", "-i", png, "-o", "r.thgit", "--tile", "16",
         "-q", "lossless", "--resume"]
    ) == 0
    assert open("r.thgit", "rb").read() == full
    assert main(["decode-tiled", "-i", "r.thgit", "-o", "r.png"]) == 0
    assert np.array_equal(load_luma("r.png"), synthetic_image(40, 24))


def test_tiled_resume_after_corruption(workdir, png):
    # A CRC-corrupt block ends the valid prefix: resume rewrites from it.
    assert main(
        ["encode-tiled", "-i", png, "-o", "c.thgit", "--tile", "16",
         "-q", "lossless"]
    ) == 0
    full = bytearray(open("c.thgit", "rb").read())
    full[-2] ^= 0xA5  # corrupt the LAST block's payload
    open("c.thgit", "wb").write(bytes(full))
    # decode must surface the corrupt block precisely
    assert main(["decode-tiled", "-i", "c.thgit", "-o", "c.png"]) == 1
    assert main(
        ["encode-tiled", "-i", png, "-o", "c.thgit", "--tile", "16",
         "-q", "lossless", "--resume"]
    ) == 0
    assert main(["decode-tiled", "-i", "c.thgit", "-o", "c.png"]) == 0
    assert np.array_equal(load_luma("c.png"), synthetic_image(40, 24))


def test_tiled_shared_table(workdir, png):
    from rustyhgi_tpu.utils.container import parse_thgit

    assert main(
        ["encode-tiled", "-i", png, "-o", "s.thgit", "--tile", "16",
         "-q", "lossless", "--format", "thgi", "--shared-table"]
    ) == 0
    _, _, _, _, freqs = parse_thgit(open("s.thgit", "rb").read())
    assert freqs is not None and int(freqs.sum()) == 1 << 14
    assert main(["decode-tiled", "-i", "s.thgit", "-o", "s.png"]) == 0
    assert np.array_equal(load_luma("s.png"), synthetic_image(40, 24))


def test_export_serialized_roundtrip():
    import numpy as np

    from rustyhgi_tpu.models.codec import HGICodec, load_exported

    c = HGICodec(3, "medium")
    img = synthetic_image(48, 32)
    enc_blob = c.export_encoder(img.shape)
    dec_blob = c.export_decoder(img.shape)
    assert isinstance(enc_blob, (bytes, bytearray)) and len(enc_blob) > 100

    enc = load_exported(enc_blob)
    dec = load_exported(dec_blob)
    g, r = enc(img)
    g2, r2 = c.encode_plane(img)
    assert np.array_equal(np.asarray(g), np.asarray(g2))
    assert np.array_equal(np.asarray(dec(np.asarray(g))), np.asarray(r2))


def test_encode_tiled_fast_roundtrips(tmp_path):
    """encode-tiled --fast: fused device-coded blocks; decode-tiled and
    --resume compose unchanged (blocks == write_fast per tile)."""
    import numpy as np
    from PIL import Image

    from rustyhgi_tpu.cli import main

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (70, 90), dtype=np.uint8)
    src = tmp_path / "in.png"
    Image.fromarray(img, mode="L").save(src)
    out = tmp_path / "t.thgit"
    assert main([
        "encode-tiled", "-i", str(src), "-o", str(out), "--tile", "32",
        "-l", "3", "-q", "medium", "--format", "thgi", "--fast",
    ]) == 0
    back = tmp_path / "back.png"
    assert main(["decode-tiled", "-i", str(out), "-o", str(back)]) == 0
    dec = np.asarray(Image.open(back))
    assert np.abs(img.astype(int) - dec.astype(int)).max() <= 20
    # Every block is the rans_tpu fast codec, byte-identical to write_fast.
    from rustyhgi_tpu.models.codec import HGICodec
    from rustyhgi_tpu.parallel.sharded import tile_plane
    from rustyhgi_tpu.utils.container import parse_thgit

    tile, width, height, blocks, freqs = parse_thgit(out.read_bytes())
    tiles, _ = tile_plane(img, (32, 32))
    codec = HGICodec(3, "medium")
    assert blocks[0] == codec.write_fast(tiles[0])


def test_cli_engine_flag(tmp_path):
    """--engine planar/xla produce byte-identical archives; bad envelope
    errors loudly."""
    import numpy as np
    from PIL import Image

    from rustyhgi_tpu.cli import main

    rng = np.random.default_rng(5)
    src = tmp_path / "in.png"
    Image.fromarray(
        rng.integers(0, 256, (48, 64), np.uint8), mode="L"
    ).save(src)
    blobs = {}
    for eng in ("auto", "planar", "xla"):
        out = tmp_path / f"{eng}.hgi"
        assert main(["encode", "-i", str(src), "-o", str(out),
                     "-l", "3", "-q", "medium", "--engine", eng]) == 0
        blobs[eng] = out.read_bytes()
    assert blobs["auto"] == blobs["planar"] == blobs["xla"]
    # planar does not cover levels < 2: loud error, no silent fallback.
    assert main(["encode", "-i", str(src), "-o", str(tmp_path / "x.hgi"),
                 "-l", "1", "-q", "medium", "--engine", "planar"]) == 1
    # ...including on the --color path (engine must not be silently
    # dropped there) and the tiled path (validated BEFORE the retry
    # tier, so no misleading transient-retry message).
    rgb = tmp_path / "rgb.png"
    Image.fromarray(
        np.zeros((32, 32, 3), np.uint8), mode="RGB"
    ).save(rgb)
    assert main(["encode", "-i", str(rgb), "-o", str(tmp_path / "c.thgic"),
                 "-l", "1", "-q", "medium", "--color",
                 "--engine", "planar"]) == 1
    assert main(["encode-tiled", "-i", str(src),
                 "-o", str(tmp_path / "t2.thgit"), "--tile", "32",
                 "-l", "1", "-q", "medium", "--format", "thgi",
                 "--engine", "planar"]) == 1


def test_encode_tiled_fast_flag_validation(tmp_path):
    """--fast must error loudly with incompatible modes, never silently
    degrade to the host entropy path."""
    import numpy as np
    from PIL import Image

    from rustyhgi_tpu.cli import main

    src = tmp_path / "in.png"
    Image.fromarray(np.zeros((32, 32), np.uint8), mode="L").save(src)
    out = tmp_path / "t.thgit"
    # The CLI error handler prints the message and exits 1 (main.rs:130-133
    # parity); the output file must not be created.
    assert main(["encode-tiled", "-i", str(src), "-o", str(out), "--tile",
                 "32", "--fast"]) == 1  # default --format hgi
    assert main(["encode-tiled", "-i", str(src), "-o", str(out), "--tile",
                 "32", "--format", "thgi", "--fast",
                 "--shared-table"]) == 1
    # Tiles beyond the device coder's exact-histogram envelope would
    # silently fall back per-tile to the host entropy path inside
    # write_fast_batch — --fast must reject them up front (ADVICE r4).
    assert main(["encode-tiled", "-i", str(src), "-o", str(out), "--tile",
                 "8192", "--format", "thgi", "--fast"]) == 1
    assert not out.exists()


@pytest.mark.parametrize("backend", ["oracle", "native"])
@pytest.mark.parametrize("engine", ["planar", "xla"])
def test_engine_needs_jax_backend(workdir, png, capsys, backend, engine):
    """An explicit --engine with a host backend is refused, not ignored."""
    rc = main(["encode", "-i", png, "-o", "e.hgi", "--backend", backend,
               "--engine", engine])
    assert rc == 1
    assert f"--engine {engine} applies to --backend jax only" in (
        capsys.readouterr().err
    )
    assert not os.path.exists("e.hgi")


def test_pgm_roundtrip_without_pillow(workdir, monkeypatch, capsys):
    """encode/decode/test on .pgm files never import Pillow."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("Pillow blocked for this test")
        return real_import(name, *args, **kwargs)

    img = synthetic_image(40, 24)
    save_gray("in.pgm", img)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert main(["encode", "-i", "in.pgm", "-o", "p.hgi", "-q", "lossless"]) == 0
    assert main(["decode", "-i", "p.hgi", "-o", "out.pgm"]) == 0
    assert main(["test", "in.pgm", "-q", "lossless", "-s", "_t"]) == 0
    assert np.array_equal(load_luma("out.pgm"), img)
    assert np.array_equal(load_luma("in_t.pgm"), img)
    # Other formats name the missing library instead of failing obscurely.
    assert main(["decode", "-i", "p.hgi", "-o", "out.png"]) == 1
    assert "needs Pillow" in capsys.readouterr().err


def test_pgm_reader_rejects_malformed(workdir):
    with open("bad.pgm", "wb") as f:
        f.write(b"P5\n4 4\n65535\n" + bytes(32))
    with pytest.raises(ValueError, match="8-bit"):
        load_luma("bad.pgm")
    with open("short.pgm", "wb") as f:
        f.write(b"P5\n# comment\n4 4\n255\n" + bytes(15))
    with pytest.raises(ValueError, match="truncated"):
        load_luma("short.pgm")
    with open("ok.pgm", "wb") as f:
        f.write(b"P5\n# comment\n4 4\n255\n" + bytes(range(16)))
    assert np.array_equal(load_luma("ok.pgm"), np.arange(16).reshape(4, 4))


def test_compile_cache_honours_env(monkeypatch):
    import jax

    from rustyhgi_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/jax")
        jax.config.update("jax_compilation_cache_dir", "/untouched")
        assert compile_cache.enable_compile_cache() == "/elsewhere/jax"
        assert jax.config.jax_compilation_cache_dir == "/untouched"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    import rustyhgi_tpu
    from rustyhgi_tpu.utils import compile_cache

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(
        rustyhgi_tpu.__file__
    )))
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(checkout, ".cache", "jax")
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
