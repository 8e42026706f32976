"""
Shared constants, dtypes, and optional-dependency shims.

Design notes
------------
The framework keeps a strict two-tier data model:

* **Host tier** (numpy, float64/int64): topology construction, UGRID
  conventions, dynamic-shape derivations.  Mirrors the role of the pure
  numpy layer in the reference (``xugrid/constants.py``).
* **Device tier** (JAX, float32 by default, int32 indices): every hot
  batched kernel (spatial queries, regrid weight build/apply, solvers).
  Static shapes, padded with ``FILL_VALUE``.

Reference parity: xugrid/constants.py:1-87.
"""

from __future__ import annotations

import numpy as np

# Fill value marking missing entries in padded dense connectivity arrays.
# UGRID files may use other fills/start indexes; they are normalized to -1
# at ingest (see ugrid/ugridbase.py).
FILL_VALUE: int = -1

# Host dtypes (numpy).
IntDType = np.int64
FloatDType = np.float64

# Device dtypes (JAX). int32 indices: half the index bytes of int64, and
# 2^31 faces is far beyond one device's memory anyway.
DeviceIntDType = np.int32
DeviceFloatDType = np.float32

IntArray = np.ndarray
FloatArray = np.ndarray
BoolArray = np.ndarray

# Tolerance for near-degenerate geometry tests: the smallest increment
# representable around 1.0 in float64, scaled by bounding box extents at
# use sites.
X_EPSILON: float = float(np.finfo(np.float64).eps)
X_OFFSET = 1e-9


class Point(np.ndarray):
    """Tiny convenience view: (x, y) as an ndarray subclass."""

    def __new__(cls, x: float, y: float):
        obj = np.asarray([x, y], dtype=np.float64).view(cls)
        return obj

    @property
    def x(self) -> float:
        return float(self[0])

    @property
    def y(self) -> float:
        return float(self[1])


class Vector(Point):
    pass


class MissingOptionalModule:
    """
    Presents a clear error message on use of a missing optional dependency.

    Reference parity: xugrid/constants.py:50-57.
    """

    def __init__(self, name: str):
        self.name = name

    def __getattr__(self, attr):
        raise ImportError(f"{self.name} is required for this functionality")

    def __call__(self, *args, **kwargs):
        raise ImportError(f"{self.name} is required for this functionality")


def optional_import(name: str):
    """Import ``name`` if available, else return a MissingOptionalModule."""
    import importlib

    try:
        return importlib.import_module(name), True
    except ImportError:
        return MissingOptionalModule(name), False
