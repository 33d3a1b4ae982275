"""Color (.thgic) container: RGB encode/decode with per-channel contracts."""

import numpy as np
import pytest

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.utils.color import decode_color, encode_color


def _rgb(h, w, seed=11):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = ((x * 2 + y * 3) // 3 % 256).astype(np.int64)
    out = np.stack(
        [(base + rng.integers(0, 25, (h, w))) % 256 for _ in range(3)], axis=2
    )
    return out.astype(np.uint8)


def test_lossless_color_exact():
    rgb = _rgb(64, 80)
    blob = encode_color(HGICodec(3, "lossless"), rgb)
    assert np.array_equal(decode_color(blob), rgb)


@pytest.mark.parametrize("quant,bound", [("low", 10), ("medium", 20), ("high", 30)])
def test_lossy_color_per_channel_bound(quant, bound):
    rgb = _rgb(61, 47)
    blob = encode_color(HGICodec(4, quant), rgb)
    back = decode_color(blob)
    err = np.abs(rgb.astype(int) - back.astype(int)).max()
    assert err <= bound


def test_lossless_picks_no_worse_transform():
    # lossless races green-delta vs identity and keeps the smaller, so it
    # can never lose to either alone; when channels share the photo's
    # structure (three tone curves of LENA) green-delta wins
    from conftest import lena_image

    from rustyhgi_tpu.utils import color as c

    y = lena_image()[:192, :256].astype(np.int64)
    rgb = np.stack(
        [y, np.clip(y * 7 // 8 + 16, 0, 255), np.clip(y * 3 // 4 + 40, 0, 255)],
        axis=2,
    ).astype(np.uint8)
    codec = HGICodec(3, "lossless")
    planes = __import__("numpy").moveaxis(rgb, 2, 0)
    blob = encode_color(codec, rgb)
    ident = c._encode_one(codec, planes, c._T_IDENTITY, "thgi")
    delta = c._encode_one(codec, planes, c._T_GDELTA, "thgi")
    assert len(blob) <= min(len(ident), len(delta))
    assert len(delta) < len(ident)  # real photo: channels correlate
    assert __import__("numpy").array_equal(decode_color(blob), rgb)


def test_cli_color_roundtrip(tmp_path):
    from rustyhgi_tpu.cli import main
    from rustyhgi_tpu.utils.color import load_rgb, save_rgb

    rgb = _rgb(48, 64)
    src, arc, out = tmp_path / "c.png", tmp_path / "c.thgic", tmp_path / "o.png"
    save_rgb(str(src), rgb)
    assert main([
        "encode", "-i", str(src), "-o", str(arc), "--color",
        "-q", "lossless", "--format", "thgi",
    ]) == 0
    assert main(["decode", "-i", str(arc), "-o", str(out)]) == 0
    assert np.array_equal(load_rgb(str(out)), rgb)


def test_bad_thgic_rejected():
    with pytest.raises(ValueError):
        decode_color(b"\x00\x00\x00\x00\x03\x00")


def test_color_preview_equals_sampled_full():
    from rustyhgi_tpu.utils.color import decode_color_preview

    rgb = _rgb(64, 80, seed=13)
    codec = HGICodec(3, "lossless")
    blob = encode_color(codec, rgb)
    full = decode_color(blob)
    for upto in (0, 1, 2, 3):
        s = 1 << (3 - upto)
        pv = decode_color_preview(blob, upto)
        assert np.array_equal(pv, full[::s, ::s, :]), upto


def test_cli_color_preview(tmp_path):
    from rustyhgi_tpu.cli import main
    from rustyhgi_tpu.utils.color import load_rgb, save_rgb

    rgb = _rgb(48, 64, seed=14)
    src, arc, out = tmp_path / "c.png", tmp_path / "c.thgic", tmp_path / "p.png"
    save_rgb(str(src), rgb)
    assert main([
        "encode", "-i", str(src), "-o", str(arc), "--color", "-q", "lossless",
        "--format", "thgi", "-l", "4",
    ]) == 0
    assert main(["decode", "-i", str(arc), "-o", str(out), "--preview", "2"]) == 0
    assert np.array_equal(load_rgb(str(out)), rgb[::4, ::4, :])


def test_reader_fuzz_clean_errors():
    """Truncated/garbage inputs to every reader raise ValueError (or
    zlib.error from a corrupt DEFLATE body) — never struct.error or a
    crash."""
    import zlib

    from rustyhgi_tpu.utils.color import decode_color_preview
    from rustyhgi_tpu.utils.container import (
        read_archive,
        read_preview,
        write_hgi,
        write_thgi,
    )

    rgb = _rgb(32, 48, seed=21)
    cblob = encode_color(HGICodec(2, "lossless"), rgb)
    gray = HGICodec(2, "medium").encode(rgb[:, :, 0])
    tblob, hblob = write_thgi(gray), write_hgi(gray)
    rng = np.random.default_rng(22)
    for trial in range(12):
        for base in (cblob, tblob, hblob):
            if trial % 2:
                data = base[: int(rng.integers(0, len(base)))]
            else:
                data = rng.integers(
                    0, 256, int(rng.integers(0, 40)), dtype=np.uint8
                ).tobytes()
            for fn in (
                decode_color,
                lambda d: decode_color_preview(d, 1),
                read_archive,
                lambda d: read_preview(d, 1),
            ):
                try:
                    fn(data)
                except (ValueError, zlib.error):
                    pass
