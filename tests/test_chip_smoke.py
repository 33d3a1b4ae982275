"""chip_smoke.py's phases at small shapes on the CPU backend.

On the card the script runs them at full size; here each phase runs its
own checks (grids vs the scalar C++ codec and the oracle, decode vs the
closed-loop recon, error bounds) on tiny planes, and the entry point must
refuse to run without a GPU.
"""

import json

import jax
import numpy as np
import pytest

import chip_smoke as cs

SMALL = {
    "grid_fullhd": dict(hw=(40, 72), batch=3),
    "grid_levels": dict(hw=(37, 70), levels=range(1, 4)),
    "grid_ragged": dict(hw=(30, 50)),
    "subband_preview": dict(hw=(40, 72)),
    "write_fast": dict(hw=(40, 72), batch=3),
    "containers": dict(hw=(40, 72)),
    "cli": dict(hw=(40, 72)),
    "cli_tiled": dict(edge=150, tile=64),
}


@pytest.mark.parametrize("name,fn", cs.SINGLE_CARD_PHASES)
def test_single_card_phase(name, fn, capsys):
    cs.run_phase(name, fn, np.random.default_rng(1), **SMALL[name])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"phase={name} ") and line.endswith(" ok")


def test_sharded_phase(capsys):
    devices = jax.devices()[:4]
    cs.run_phase("sharded", cs.phase_sharded, np.random.default_rng(2),
                 devices, hw=(40, 72), batch=8)
    assert "(4,1) (2,2)" in capsys.readouterr().out


def test_check_grid_catches_a_wrong_byte():
    image = cs.gradient_planes(np.random.default_rng(3), 1, 24, 40)[0]
    grid = cs.native_encode(image, 3, cs.MEDIUM)
    cs.check_grid(grid, image, 3, cs.MEDIUM, oracle=True)
    grid[5, 7] ^= 1
    with pytest.raises(cs.SmokeFailure, match="native_encode"):
        cs.check_grid(grid, image, 3, cs.MEDIUM)


def test_check_decode_enforces_the_bound():
    image = np.full((8, 8), 100, np.uint8)
    off = image + np.uint8(21)
    cs.check_decode(image + np.uint8(20), image + np.uint8(20), image, cs.MEDIUM)
    with pytest.raises(cs.SmokeFailure, match="21 > 20"):
        cs.check_decode(off, off, image, cs.MEDIUM)


def test_refuses_without_a_gpu(capsys):
    assert cs.main([]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "no GPU" in err
    with pytest.raises(json.JSONDecodeError):
        json.loads(out or "not json")
