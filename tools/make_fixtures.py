"""Generate the pinned BASELINE-config interop fixture corpus.

Writes tests/golden/baseline/: .hgi/.thgi archives for the anchor config
(LENA.TIF — TIF is the cross-tool interop anchor, SURVEY.md §6) and a
manifest of sha256 digests + sizes for every BASELINE.json config
(JPEG-sourced images pin digests instead of multi-MB archive bytes).
tests/test_baseline_fixtures.py re-derives everything and fails on any
drift.  Needs the reference repository's res/ images:

    python tools/make_fixtures.py <reference>/res
"""
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Fixtures are made on the CPU, like the tests that check them.
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

from rustyhgi_tpu.models.codec import HGICodec
from rustyhgi_tpu.ops.quantizers import linear_error
from rustyhgi_tpu.utils.container import write_archive
from rustyhgi_tpu.utils.compile_cache import enable_compile_cache
from rustyhgi_tpu.utils.imageio import load_luma

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "golden", "baseline")

CONFIGS = [
    # (name, image, levels, preset, commit .hgi/.thgi bytes?)
    ("lena_l4_lossless", "LENA.TIF", 4, "lossless", True),
    ("lena_l4_medium", "LENA.TIF", 4, "medium", True),
    ("fullhd_l4_low", "fullhd.jpg", 4, "low", False),
    ("fullhd_l4_medium", "fullhd.jpg", 4, "medium", False),
    ("fullhd_l4_high", "fullhd.jpg", 4, "high", False),
    ("ikonos_l4_lossless", "ikonos-barcelona-spain.jpg", 4, "lossless", False),
]


def sha(b) -> str:
    return hashlib.sha256(b).hexdigest()


def main(res):
    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, image, levels, preset, commit_bytes in CONFIGS:
        img = load_luma(os.path.join(res, image))
        codec = HGICodec(levels, preset)
        grid, recon = codec.encode_plane(img)
        grid = np.asarray(grid)
        decoded = np.asarray(recon)
        from rustyhgi_tpu.utils.container import Archive
        archive = Archive(codec.metadata_for(*img.shape), grid)
        hgi = write_archive(archive, "hgi")
        thgi = write_archive(archive, "thgi")
        fast = codec.write_fast(img)  # rowmajor + device-rANS (rans_tpu)
        err = int(np.abs(img.astype(np.int16) - decoded.astype(np.int16)).max())
        bound = linear_error(codec.quantization)
        assert err <= bound, (name, err, bound)
        entry = {
            "image": image,
            "levels": levels,
            "preset": preset,
            "input_sha256": sha(img.tobytes()),
            "input_shape": list(img.shape),
            "hgi_sha256": sha(hgi),
            "hgi_bytes": len(hgi),
            "thgi_sha256": sha(thgi),
            "thgi_bytes": len(thgi),
            "fast_thgi_sha256": sha(fast),
            "fast_thgi_bytes": len(fast),
            "decoded_sha256": sha(decoded.tobytes()),
            "max_abs_error": err,
            "error_bound": bound,
        }
        if commit_bytes:
            with open(os.path.join(OUT, name + ".hgi"), "wb") as f:
                f.write(hgi)
            with open(os.path.join(OUT, name + ".thgi"), "wb") as f:
                f.write(thgi)
        manifest[name] = entry
        print(f"{name}: hgi {len(hgi)} B, thgi {len(thgi)} B, "
              f"fast {len(fast)} B, max|err| {err} <= {bound}")
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    print("wrote", os.path.join(OUT, "manifest.json"))


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python tools/make_fixtures.py <reference>/res")
    main(sys.argv[1])
