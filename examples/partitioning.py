"""
Partitioning & multi-chip sharding (reference: examples/partitioning.py,
plus the mesh-sharded execution that replaces the reference's
offline MPI-partition merges).

Run with virtual devices to see the multi-chip path on CPU:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/partitioning.py
"""

import numpy as np

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import os

import jax

if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    # Virtual CPU devices requested: switch platforms before anything
    # (even jax.devices()) pins the backend.
    jax.config.update("jax_platforms", "cpu")

import xugrid_tpu as xu

uda = xu.data.elevation_nl(n_points=4000)

# Spatial decomposition with the Hilbert SFC partitioner.  (The
# accessor's label_partitions uses the data as integer weights; for
# unweighted partitioning label via the grid.)
labels = uda.grid.label_partitions(n_part=4)
parts = uda.ugrid.partition_by_label(labels)
print("parts:", [p.grid.n_face for p in parts])

# Reassemble: node/face dedup across partition boundaries.
merged = xu.merge_partitions(parts)
assert merged.grids[0].n_face == uda.grid.n_face
print("merge round-trip OK")

# Multi-chip SPMD: shard the face dimension over a device mesh.
if len(jax.devices()) >= 4:
    from jax.sharding import Mesh

    from xugrid_tpu.core.sparse import MatrixCSR, PaddedCSR
    from xugrid_tpu.parallel import (
        ShardedRegrid,
        partition_order,
        sharded_laplace_smooth,
    )

    grid = uda.grid
    order = partition_order(grid.centroids)
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    values = np.asarray(uda.values, dtype=np.float32)[order]

    mesh = Mesh(np.array(jax.devices()[:4]), ("faces",))
    neighbors = grid.format_connectivity_as_dense(
        grid.face_face_connectivity
    )[order]
    neighbors = np.where(neighbors >= 0, remap[np.maximum(neighbors, 0)], -1)
    # Jacobi smoothing with one all_to_all halo exchange per step.
    smoothed = sharded_laplace_smooth(mesh, neighbors, values, n_steps=3)
    print(
        "sharded smoothing:",
        f"var {values.var():.2f} -> {smoothed.var():.2f}",
    )
else:
    print("fewer than 4 devices; skipping the sharded demo")
