"""
Full workload benchmark suite (BASELINE.json "configs"; BASELINE.md).

One JSON line per workload:

1. elevation_nl (~52k-face triangular mesh): OverlapRegridder mean to a
   regular raster (weight build + apply).
2. adh_san_diego (time-varying node depth): BarycentricInterpolator +
   CentroidLocatorRegridder over all timesteps.
3. xoxo triangle mesh: voronoi tessellation + Laplace-CG fill +
   face_face connectivity derivations.
4. 1M-face synthetic mesh: line burn (array path) + 4-way partition /
   merge round trip.
5. scaled synthetic mesh: celltree cross-sections + relative-overlap
   regrid (BENCH_XL=1 for the 10M-face north star).

Usage: python benchmarks/suite.py   (BENCH_SMALL=1 shrinks everything)
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from xugrid_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

SMALL = os.environ.get("BENCH_SMALL") == "1"
XL = os.environ.get("BENCH_XL") == "1"


def emit(workload: str, **fields):
    print(json.dumps({"workload": workload, **fields}))


def quad_mesh(nx, ny, dx=1.0):
    x = np.arange(nx + 1.0) * dx
    y = np.arange(ny + 1.0) * dx
    yy, xx = np.meshgrid(y, x, indexing="ij")
    verts = np.column_stack([xx.ravel(), yy.ravel()])
    j, i = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    nid = lambda ii, jj: jj * (nx + 1) + ii  # noqa: E731
    faces = np.stack(
        [nid(i, j), nid(i + 1, j), nid(i + 1, j + 1), nid(i, j + 1)], axis=-1
    ).reshape(-1, 4)
    return verts, faces


def workload_elevation_nl():
    import xugrid_tpu as xu

    n_points = 3000 if SMALL else 26000
    uda = xu.data.elevation_nl(n_points=n_points)
    grid = uda.grid
    xmin, ymin, xmax, ymax = grid.bounds
    res = max(xmax - xmin, ymax - ymin) / (64 if SMALL else 512)
    t0 = time.perf_counter()
    target = xu.Ugrid2d.from_structured_intervals1d(
        np.arange(xmin, xmax + res, res), np.arange(ymin, ymax + res, res)
    )
    regridder = xu.OverlapRegridder(uda, target, method="mean")
    build_s = time.perf_counter() - t0
    _ = np.asarray(regridder.regrid(uda).values)  # compile warm-up
    t0 = time.perf_counter()
    out = regridder.regrid(uda)
    sink = float(np.nansum(np.asarray(out.values)))
    apply_s = time.perf_counter() - t0
    emit(
        "elevation_nl_overlap_mean",
        n_face=grid.n_face,
        n_target=target.n_face,
        weight_build_s=round(build_s, 4),
        apply_s=round(apply_s, 4),
        checksum=round(sink, 3),
    )


def workload_adh_san_diego():
    import xugrid_tpu as xu

    n_times = 4 if SMALL else 50
    uds = xu.data.adh_san_diego(n_times=n_times)
    depth = uds["depth"]
    grid = uds.grids[0]
    # Face-centered copy for the face-based regridders.
    depth_face = xu.UgridDataArray(
        depth.obj.rename("depth_face"), grid
    ).ugrid.to_face().mean("nmax")

    xmin, ymin, xmax, ymax = grid.bounds
    res = max(xmax - xmin, ymax - ymin) / (32 if SMALL else 256)
    target = xu.Ugrid2d.from_structured_intervals1d(
        np.arange(xmin, xmax + res, res), np.arange(ymin, ymax + res, res)
    )
    t0 = time.perf_counter()
    bary = xu.BarycentricInterpolator(depth_face, target)
    cent = xu.CentroidLocatorRegridder(depth_face, target)
    build_s = time.perf_counter() - t0
    _ = np.asarray(bary.regrid(depth_face).values)  # compile warm-up
    _ = np.asarray(cent.regrid(depth_face).values)
    t0 = time.perf_counter()
    out1 = bary.regrid(depth_face)
    out2 = cent.regrid(depth_face)
    sink = float(
        np.nansum(np.asarray(out1.values)) + np.nansum(np.asarray(out2.values))
    )
    apply_s = time.perf_counter() - t0
    emit(
        "adh_san_diego_timeseries",
        n_face=grid.n_face,
        n_times=n_times,
        n_target=target.n_face,
        weight_build_s=round(build_s, 4),
        apply_s=round(apply_s, 4),
        checksum=round(sink, 3),
    )


def workload_xoxo():
    import xugrid_tpu as xu
    from xugrid_tpu import xdata

    grid = xu.data.xoxo()
    t0 = time.perf_counter()
    voronoi = grid.tesselate_centroidal_voronoi()
    voronoi_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _ = grid.face_face_connectivity
    _ = grid.node_node_connectivity
    _ = grid.edge_edge_connectivity
    conn_s = time.perf_counter() - t0

    values = np.asarray(grid.centroids[:, 0], dtype=float).copy()
    rng = np.random.default_rng(0)
    values[rng.random(grid.n_face) < 0.3] = np.nan
    uda = xu.UgridDataArray(
        xdata.DataArray(values, dims=(grid.face_dimension,), name="z"), grid
    )
    t0 = time.perf_counter()
    filled = uda.ugrid.laplace_interpolate(atol=1e-8)
    laplace_s = time.perf_counter() - t0
    assert not np.isnan(np.asarray(filled.values)).any()
    emit(
        "xoxo_voronoi_laplace",
        n_face=grid.n_face,
        voronoi_faces=voronoi.n_face,
        voronoi_s=round(voronoi_s, 4),
        connectivity_s=round(conn_s, 4),
        laplace_s=round(laplace_s, 4),
    )


def workload_burn_partition():
    import xugrid_tpu as xu
    from xugrid_tpu.ugrid.burn import _locate_polygon

    n_side = 100 if SMALL else 1000
    verts, faces = quad_mesh(n_side, n_side)
    grid = xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)

    # Polygon burn via the array path (no shapely needed).
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    burned = np.full(grid.n_face, np.nan)
    for k in range(12):
        cx, cy = rng.uniform(0.2 * n_side, 0.8 * n_side, 2)
        angle = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        radius = rng.uniform(0.05, 0.15) * n_side * (
            1 + 0.2 * np.sin(3 * angle)
        )
        ring = np.column_stack(
            [cx + radius * np.cos(angle), cy + radius * np.sin(angle)]
        )
        located = _locate_polygon(grid, ring, [], all_touched=False)
        burned[located] = float(k)
    burn_s = time.perf_counter() - t0

    from xugrid_tpu import xdata

    uda = xu.UgridDataArray(
        xdata.DataArray(burned, dims=(grid.face_dimension,), name="id"), grid
    )
    t0 = time.perf_counter()
    parts = uda.ugrid.partition(4)
    merged = xu.merge_partitions(parts)
    partition_s = time.perf_counter() - t0
    assert merged.grids[0].n_face == grid.n_face
    emit(
        "burn_partition_roundtrip",
        n_face=grid.n_face,
        n_polygons=12,
        burn_s=round(burn_s, 4),
        partition_merge_s=round(partition_s, 4),
        burned_faces=int(np.isfinite(burned).sum()),
    )


def workload_cross_sections():
    import xugrid_tpu as xu
    from xugrid_tpu import xdata

    n_side = 100 if SMALL else (3163 if XL else 1000)
    verts, faces = quad_mesh(n_side, n_side)
    grid = xu.Ugrid2d(verts[:, 0], verts[:, 1], -1, faces)
    uda = xu.UgridDataArray(
        xdata.DataArray(
            np.asarray(grid.centroids).sum(axis=1),
            dims=(grid.face_dimension,),
            name="z",
        ),
        grid,
    )
    n_lines = 4 if SMALL else 32
    t0 = time.perf_counter()
    total = 0
    for k in range(n_lines):
        y = (k + 0.5) * n_side / n_lines
        section = uda.ugrid.intersect_line(start=(0.0, y), end=(n_side, y))
        total += section.size
    section_s = time.perf_counter() - t0

    t_side = max(8, n_side // 2)
    dx = n_side / t_side
    tverts, tfaces = quad_mesh(t_side, t_side, dx=dx)
    target = xu.Ugrid2d(tverts[:, 0], tverts[:, 1], -1, tfaces)
    regridder = xu.RelativeOverlapRegridder(uda, target)
    _ = np.asarray(regridder.regrid(uda).values)  # compile warm-up
    t0 = time.perf_counter()
    out = regridder.regrid(uda)
    sink = float(np.nansum(np.asarray(out.values)))
    regrid_s = time.perf_counter() - t0
    emit(
        "cross_sections_relative_overlap",
        n_face=grid.n_face,
        n_lines=n_lines,
        section_values=total,
        sections_s=round(section_s, 4),
        relative_overlap_s=round(regrid_s, 4),
        checksum=round(sink, 3),
    )


def main():
    for workload in (
        workload_elevation_nl,
        workload_adh_san_diego,
        workload_xoxo,
        workload_burn_partition,
        workload_cross_sections,
    ):
        try:
            workload()
        except Exception as exc:  # pragma: no cover - report and continue
            emit(workload.__name__, error=repr(exc))


if __name__ == "__main__":
    main()
