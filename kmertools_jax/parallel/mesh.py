"""Device mesh plumbing.

The reference's parallelism is a single node's worth of rayon threads
pulling off a mutex (SURVEY.md section 2 table). This design replaces
that with a 1-D `jax.sharding.Mesh` over devices: reads are
data-parallel over the mesh, the k-mer space is hash-sharded for
counting, and collectives (psum / all_to_all) run between the devices
of one host (NVLink on a multi-GPU host). The mesh follows the
algorithm alone: every device reaches every other at the same rate.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(
    n_devices: int | None = None, axis: str = DATA_AXIS, devices=None
) -> Mesh:
    """1-D mesh over this process's ADDRESSABLE devices.

    Local on purpose: the multi-host runtime (parallel/multihost.py)
    shards the input FILE across hosts and each host computes its part
    independently, so meshes never span processes — collectives stay
    inside the host. `devices` pins an explicit device list (heterogeneous sinks
    split the accelerator mesh from the host-CPU devices)."""
    devs = list(devices) if devices is not None else jax.local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(mesh: Mesh, arr, axis: str = DATA_AXIS):
    """Place `arr` row-sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(arr, sharding)


def pad_rows_to_devices(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad the leading dim to a multiple of n (shard_map requirement)."""
    r = arr.shape[0] % n
    if r == 0:
        return arr
    pad = np.full((n - r,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
