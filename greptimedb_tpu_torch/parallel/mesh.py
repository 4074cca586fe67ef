"""The device mesh of multi-device execution.

Counterpart of `greptimedb_tpu/parallel/mesh.py`.  The reference's mesh
is a 1-D `regions` axis over jax devices, driven by `shard_map`; here it
is a tuple of torch device slots, driven by one process that runs each
slot's partial aggregates on the slot's device and folds them on the
first (parallel/tile_program.py `mesh_run`, K22).  A device may fill
several slots (`["cuda:0"] * 4`, or `["cpu"] * 8` in the tests): the
placement, the partials, the gather and the fold are the same, only the
copies between distinct cards are absent.  Slots are therefore keyed by
index, never by device identity.
"""

from __future__ import annotations

import torch

REGION_AXIS = "regions"


def make_mesh(n_devices: int | None = None, devices=None) -> tuple[torch.device, ...]:
    """The first `n_devices` slots of `devices` (all of them when None)."""
    slots = tuple(torch.device(d) for d in (devices if devices is not None else ("cuda",)))
    if n_devices is not None:
        if n_devices > len(slots):
            raise ValueError(f"requested {n_devices} devices but only {len(slots)} available")
        slots = slots[:n_devices]
    return slots


def region_device_index(region_id: int, n_devices: int) -> int:
    """Stable region -> mesh slot (the co-location contract): a region's
    chunks start at this slot, and the TQL mesh route runs the region's
    partial there."""
    if n_devices <= 0:
        return 0
    return int(region_id) % int(n_devices)
