"""Test configuration.

Tests run on the CPU with 8 virtual XLA devices, so sharding/mesh tests
exercise real multi-device SPMD partitioning without an accelerator (the
program itself runs on the GPU: ``python chip_smoke.py``).  Environment
must be set before jax is imported anywhere.
"""

import os

# Tests never use an accelerator, even where the environment names one.
os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from rustyhgi_tpu.utils.compile_cache import enable_compile_cache

# Persistent compilation cache: the parametrized matrix compiles hundreds of
# small executables; caching makes re-runs fast.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

GOLDEN_BASELINE = os.path.join(os.path.dirname(__file__), "golden", "baseline")

# Directory holding the reference repository's res/ images (LENA.TIF,
# fullhd.jpg, ikonos-barcelona-spain.jpg); tests that need them skip
# when it is unset or absent.
REFERENCE_RES_ENV = "HGI_REFERENCE_RES"


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def synthetic_image(width: int, height: int) -> np.ndarray:
    """The reference's synthetic fixture: pixel = (x*y) as u8 (lib.rs:36-43)."""
    x = np.arange(width, dtype=np.int64)
    y = np.arange(height, dtype=np.int64)
    return ((y[:, None] * x[None, :]) & 0xFF).astype(np.uint8)


def lena_image() -> np.ndarray:
    """res/LENA.TIF's luma plane, rebuilt exactly from the committed
    lossless archive (tests/golden/baseline/lena_l4_lossless.hgi)."""
    from rustyhgi_tpu.oracle import oracle_decode
    from rustyhgi_tpu.utils.container import read_archive

    with open(os.path.join(GOLDEN_BASELINE, "lena_l4_lossless.hgi"), "rb") as f:
        archive = read_archive(f.read())
    return oracle_decode(archive.grid, archive.metadata.scale_level)


def reference_image(name: str) -> np.ndarray:
    """Luma plane of a reference res/ image; skips the calling test when
    the images are not available (see REFERENCE_RES_ENV)."""
    from rustyhgi_tpu.utils.imageio import load_luma

    root = os.environ.get(REFERENCE_RES_ENV)
    path = os.path.join(root, name) if root else None
    if path is None or not os.path.exists(path):
        pytest.skip(f"{name} needs the reference res/ images (${REFERENCE_RES_ENV})")
    return load_luma(path)


@pytest.fixture
def lena() -> np.ndarray:
    return lena_image()
