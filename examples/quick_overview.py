"""
Quick overview: open, select, plot (reference: examples/quick_overview.py).

Runs on CPU or GPU; writes a UGRID NetCDF file, reads it back, and
makes topology-aware selections.
"""

import numpy as np

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import xugrid_tpu as xu

# A synthetic triangular elevation mesh (no downloads).
uda = xu.data.elevation_nl(n_points=4000)
print(uda.grid)
print("faces:", uda.grid.n_face, "nodes:", uda.grid.n_node)

# Topology-aware selection: a horizontal cross-section...
section = uda.ugrid.sel(y=150e3)
print("cross-section values:", section.size)

# ...point probes...
pts = uda.ugrid.sel_points(
    x=[125e3, 150e3], y=[150e3, 160e3], out_of_bounds="drop"
)
print("point values:", np.asarray(pts.values))

# ...and a bounding-box clip (renumbers the topology).
box = uda.ugrid.sel(x=slice(50e3, 200e3), y=slice(100e3, 200e3))
print("clipped faces:", box.grid.n_face)

# UGRID NetCDF round-trip.
import tempfile
from pathlib import Path

path = Path(tempfile.mkdtemp()) / "elevation.nc"
uda.ugrid.to_netcdf(path)
back = xu.open_dataset(path)
assert back.grid.n_face == uda.grid.n_face
print("round-trip OK:", path)

# Plotting (if matplotlib is installed).
try:
    import matplotlib

    matplotlib.use("Agg")
    artist = uda.ugrid.plot(robust=True)
    artist.figure.savefig(Path(tempfile.mkdtemp()) / "elevation.png", dpi=60)
    print("plotted")
except ImportError:
    pass
