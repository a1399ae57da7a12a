"""Device-mesh setup and sharding helpers.

The reference is single-node multiprocessing (SURVEY.md §2c); telr_jax's
distributed design is first-class:

  * axis "reads" — data parallelism over read batches (the reference index is
    replicated per host, reads stream across the mesh),
  * axis "loci"  — locus parallelism for batched per-locus work (assembly,
    AF realignment, liftover), fed by an all-to-all redistribution of
    (locus, read) pairs after SV detection.

Multi-host initialization goes through jax.distributed.initialize (call
`init_distributed` once per process before building meshes).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

READS_AXIS = "reads"
LOCI_AXIS = "loci"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op on a single process)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(n_devices: Optional[int] = None,
              loci_parallel: int = 1) -> Mesh:
    """Build a ("reads", "loci") mesh over the available devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n % loci_parallel != 0:
        raise ValueError("n_devices must be divisible by loci_parallel")
    arr = np.array(devices[:n]).reshape(n // loci_parallel, loci_parallel)
    return Mesh(arr, (READS_AXIS, LOCI_AXIS))


def shard_batch(mesh: Mesh, *arrays):
    """Place batch-major arrays with the batch dim sharded over "reads"."""
    sh = NamedSharding(mesh, P(READS_AXIS))
    return tuple(jax.device_put(a, sh) for a in arrays)


def replicated(mesh: Mesh, *arrays):
    sh = NamedSharding(mesh, P())
    return tuple(jax.device_put(a, sh) for a in arrays)


def pad_to_multiple(a: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    """Pad the batch axis so it divides evenly across mesh shards."""
    n = a.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return a
    pad_widths = [(0, 0)] * a.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(a, pad_widths, constant_values=fill)
