"""Multi-chip execution: data-parallel record batches over a device mesh.

The reference has no distributed backend (SURVEY §2.5); the multi-device
scaling design is:

- the record batch dimension is sharded over the ``dp`` mesh axis;
- the MSA gap index and the reference byte buffer are replicated (they are
  read-only gather targets; ~3% of genome size per founder sequence after
  bit-packing, so replication is cheap up to many-founder scales);
- per-batch statistics are produced as replicated outputs, which makes XLA
  insert the (only) cross-device all-reduce.

With this layout the projection kernel runs without any other collectives —
reads are independent — so scaling efficiency is bounded by input routing,
not ICI traffic.  QNAME-group locality for downstream MAPQ grouping is
preserved by routing whole read groups to the same shard on the host side.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_batch_arrays(mesh: Mesh, arrays: dict, axis: str = "dp") -> dict:
    """device_put each array with its leading (batch) dim sharded over
    ``axis``; scalars/1-elem arrays are replicated."""
    out = {}
    for name, arr in arrays.items():
        if getattr(arr, "ndim", 0) >= 1 and arr.shape[0] >= mesh.devices.size:
            spec = P(axis, *([None] * (arr.ndim - 1)))
        else:
            spec = P()
        out[name] = jax.device_put(arr, NamedSharding(mesh, spec))
    return out


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (e.g. the DeviceGapIndex) over the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)
