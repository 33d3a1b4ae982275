"""Device mesh construction helpers.

The reference is single-threaded scalar code with no parallelism anywhere
(SURVEY.md §2); every parallel axis in this framework is designed, not
ported.  The codec's natural axes are:

* ``data`` — independent images of a batch (pure data parallelism), and
* ``tile`` — spatial tiles of one large image (the gigapixel axis).

Both axes shard *independent HGI streams* (tiles are separate archives, so
there are no halos — SURVEY.md §2 table), which means the per-device
compute is the unmodified single-plane kernel and the only communication
is the psum of entropy-coder statistics plus the host-side ordered gather
of compressed blocks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "DATA_AXIS", "TILE_AXIS"]

DATA_AXIS = "data"
TILE_AXIS = "tile"


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, tile) mesh over the given (default: all) devices.

    ``shape=None`` puts all devices on the data axis.  The cards of one
    host are joined all to all by NVLink, so the mesh shape follows the
    workload alone, not the device order.
    """
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices), 1)
    if shape[0] * shape[1] != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    dev_array = np.array(devices).reshape(shape)
    return Mesh(dev_array, (DATA_AXIS, TILE_AXIS))
