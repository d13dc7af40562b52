"""Multi-host distributed execution (SURVEY §2.5 P4).

The reference's distributed layer is MPI-lite: rank 0 reads setup files
and broadcasts (utilities/easy_netcdf_read_mpi.F90:1-60,
ifsaux/mpl_module.F90:29-67); the compute itself is embarrassingly
parallel over columns.  Here the I/O is turned inside-out:

* ``initialize()`` wires ``jax.distributed`` (env-driven on a cluster,
  explicit coordinator for tests) and no-ops in single-process runs.
* LUT tables are *replicated* by closure (every host reads them at
  setup — they are small and local; the analog of the MPI broadcast
  without a broadcast).
* Columns are sharded over the global mesh; each host reads ONLY its
  column slab from the input NetCDF (``read_input_distributed`` →
  io/netcdf.NcFile(col_range=...)) and writes only its shard of the
  outputs (``local_flux``/per-shard files).  There is no cross-host
  communication in the hot path — collectives ride ICI/DCN only if the
  caller asks for global diagnostics.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed if a multi-process environment is
    configured; returns True when running multi-process.

    With no arguments, initializes from the standard cluster env
    (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID).  Single-process runs return
    False without touching the distributed runtime."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        n = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(n) if n else None
    if process_id is None:
        p = os.environ.get("JAX_PROCESS_ID")
        process_id = int(p) if p else None
    if coordinator_address is None and num_processes in (None, 1):
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_count() > 1


def global_mesh() -> jax.sharding.Mesh:
    """1-D column-DP mesh over ALL devices of all processes."""
    return jax.sharding.Mesh(np.array(jax.devices()),
                             axis_names=("columns",))


def column_slab(mesh: jax.sharding.Mesh, ncol: int
                ) -> Tuple[int, int, int]:
    """This process's contiguous column slab under column sharding.

    Returns (start, stop, ncol_padded): ncol is padded up to the device
    count so every device owns an equal contiguous slice; the padding
    columns (clamped copies) are produced by the caller and dropped
    after the run."""
    n_dev = mesh.devices.size
    padded = -(-ncol // n_dev) * n_dev
    per_dev = padded // n_dev
    local = [d for d in mesh.devices.flat
             if d.process_index == jax.process_index()]
    first = min(d.id for d in local)
    ordered = sorted(d.id for d in mesh.devices.flat)
    pos = ordered.index(first)
    start = pos * per_dev
    stop = start + per_dev * len(local)
    return min(start, ncol), min(stop, ncol), padded


def read_input_distributed(path: str, driver_config=None,
                           mesh: Optional[jax.sharding.Mesh] = None,
                           dtype=np.float64):
    """Per-host sharded input read: each process reads only its column
    slab (reference analog inverted — see module docstring).

    Returns (inp, slab): a RadiationInput holding the LOCAL columns and
    (start, stop, ncol_global)."""
    from ecrad_tpu.io.input import read_input
    from ecrad_tpu.io.netcdf import NcFile

    mesh = mesh or global_mesh()
    with NcFile(path) as f:
        ncol = f.dimensions().get("column")
        if not ncol:  # record dims read as None in NetCDF3
            ncol = f.get("pressure_hl").shape[0]
    start, stop, _ = column_slab(mesh, ncol)
    inp = read_input(path, driver_config, dtype=dtype,
                     col_range=(start, stop))
    return inp, (start, stop, ncol)


def make_global_inputs(mesh: jax.sharding.Mesh, tree, ncol_local: int,
                       ncol_global: int):
    """Assemble process-local column slabs into global column-sharded
    jax.Arrays (LUT-sized leaves are replicated)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = mesh.devices.size
    padded = -(-ncol_global // n_dev) * n_dev
    col_sh = NamedSharding(mesh, P("columns"))
    rep_sh = NamedSharding(mesh, P())
    # pad the LAST process's slab so the global padded shape divides
    local_pad = 0
    start, stop, _ = column_slab(mesh, ncol_global)
    n_local_dev = len([d for d in mesh.devices.flat
                       if d.process_index == jax.process_index()])
    per_dev = padded // n_dev
    local_target = per_dev * n_local_dev
    local_pad = local_target - (stop - start)

    def put(x):
        if x is None or not hasattr(x, "ndim") or x.ndim == 0:
            return x
        if x.shape[0] == ncol_local:
            if local_pad:
                reps = np.broadcast_to(np.asarray(x)[-1:],
                                       (local_pad,) + x.shape[1:])
                x = np.concatenate([np.asarray(x), reps], axis=0)
            return jax.make_array_from_process_local_data(
                col_sh, np.asarray(x), (padded,) + x.shape[1:])
        return jax.device_put(np.asarray(x), rep_sh)

    return jax.tree_util.tree_map(put, tree), padded


def local_flux(flux, start: int, stop: int, per_dev_start: int = None):
    """Extract this process's column slab of a global sharded Flux as
    host numpy arrays (for per-shard output writes)."""
    def pull(x):
        if x is None or not hasattr(x, "addressable_shards"):
            return x
        shards = sorted(x.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards],
                              axis=0)[:stop - start]

    return jax.tree_util.tree_map(pull, flux)
