"""Pinned interop fixture corpus for every BASELINE.json config.

tests/golden/baseline/manifest.json pins, for each config, the luma
input digest (fixing the JPEG/TIFF decode), the .hgi/.thgi archive
digests + sizes, and the decoded-pixel digest; the anchor LENA.TIF
configs additionally commit the archive bytes themselves (TIF is the
cross-tool interop anchor — SURVEY.md §6).  A future environment with
the reference Rust toolchain can verify interop one-shot against these
artifacts; meanwhile they freeze the whole encode->container pipeline
byte-for-byte (regenerate with tools/make_fixtures.py).  The LENA input
is rebuilt from its committed lossless archive; the other images come
from the reference's res/ directory and skip without it.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.utils.container import Archive, read_archive, write_archive

from conftest import lena_image, reference_image

BASE = os.path.join(os.path.dirname(__file__), "golden", "baseline")

with open(os.path.join(BASE, "manifest.json")) as f:
    MANIFEST = json.load(f)


def sha(b) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_baseline_config_rederives(name):
    entry = MANIFEST[name]
    if entry["image"] == "LENA.TIF":
        img = lena_image()
    else:
        img = reference_image(entry["image"])
    assert list(img.shape) == entry["input_shape"]
    assert sha(img.tobytes()) == entry["input_sha256"], (
        "input luma drifted (image decode changed)"
    )

    codec = HGICodec(entry["levels"], entry["preset"])
    grid, recon = codec.encode_plane(img)
    archive = Archive(codec.metadata_for(*img.shape), np.asarray(grid))
    hgi = write_archive(archive, "hgi")
    thgi = write_archive(archive, "thgi")
    assert len(hgi) == entry["hgi_bytes"] and sha(hgi) == entry["hgi_sha256"]
    assert len(thgi) == entry["thgi_bytes"] and sha(thgi) == entry["thgi_sha256"]
    if "fast_thgi_sha256" in entry:
        # The device entropy format (write_fast: rowmajor layout, rans_tpu
        # codec — grid + lane-parallel device rANS in one program) is
        # pinned byte-for-byte too, and must read back to the same grid.
        fast = codec.write_fast(img)
        assert len(fast) == entry["fast_thgi_bytes"]
        assert sha(fast) == entry["fast_thgi_sha256"]
        from rustyhgi_tpu.utils.container import read_thgi

        assert np.array_equal(read_thgi(fast).grid, np.asarray(grid))

    decoded = np.asarray(recon)
    assert sha(decoded.tobytes()) == entry["decoded_sha256"]
    err = int(np.abs(img.astype(np.int16) - decoded.astype(np.int16)).max())
    assert err == entry["max_abs_error"] <= entry["error_bound"]


@pytest.mark.parametrize(
    "name", [n for n, e in sorted(MANIFEST.items()) if e["image"] == "LENA.TIF"]
)
def test_committed_anchor_archives(name):
    """The committed LENA archives parse, match the manifest, and decode
    to the pinned pixels."""
    entry = MANIFEST[name]
    for ext in ("hgi", "thgi"):
        with open(os.path.join(BASE, f"{name}.{ext}"), "rb") as f:
            blob = f.read()
        assert sha(blob) == entry[f"{ext}_sha256"]
        archive = read_archive(blob)
        assert archive.metadata.width == entry["input_shape"][1]
        assert archive.metadata.height == entry["input_shape"][0]
        codec = HGICodec(entry["levels"], entry["preset"])
        decoded = np.asarray(codec.decode(archive))
        assert sha(decoded.tobytes()) == entry["decoded_sha256"]
