"""
NetworkGridder: grid 1D network (edge) data onto a 2D grid by
length-of-intersection weights.

Parity: xugrid/regrid/gridder.py:24-86, network.py:4-35.
"""

from __future__ import annotations

from typing import Callable, Union

from xugrid_tpu.core.sparse import MatrixCSR
from xugrid_tpu.regrid import reduce
from xugrid_tpu.regrid.regridder import BaseRegridder, setup_grid
from xugrid_tpu.regrid.structured import StructuredGrid2d
from xugrid_tpu.regrid.unstructured import Network1d, UnstructuredGrid2d


def _convert_target(target):
    if isinstance(target, StructuredGrid2d):
        return target.convert_to(UnstructuredGrid2d)
    return target


class NetworkGridder(BaseRegridder):
    """
    Grid data living on the edges of a Ugrid1d network onto the faces of
    a 2D grid, weighting by intersection length.

    Parameters
    ----------
    source: Ugrid1d or UgridDataArray over a network
    target: Ugrid2d, UgridDataArray, or structured DataArray
    method: str or callable, default "mean"
    """

    _METHODS = reduce.ABSOLUTE_OVERLAP_METHODS

    def __init__(self, source, target, method: Union[str, Callable] = "mean"):
        self._source = Network1d(source)
        self._target = setup_grid(target)
        self._weights = None
        self._padded = None
        self._compute_weights(self._source, self._target, relative=False)
        self._setup_regrid(method)

    @property
    def weights(self):
        return self.to_dataset()

    @weights.setter
    def weights(self, weights):
        if not isinstance(weights, MatrixCSR):
            raise TypeError(
                f"Expected MatrixCSR, received: {type(weights).__name__}"
            )
        self._weights = weights
        self._padded = None

    @classmethod
    def _weights_from_dataset(cls, dataset) -> MatrixCSR:
        return cls._csr_from_dataset(dataset)

    def _compute_weights(self, source, target, relative: bool) -> None:
        target = _convert_target(target)
        self._target = target
        source_index, target_index, weight_values = target.intersection_length(
            source, relative=relative
        )
        self._weights = MatrixCSR.from_triplet(
            target_index, source_index, weight_values,
            n=target.size, m=source.size,
        )
        self._padded = None

    @classmethod
    def from_weights(cls, weights, target, method: Union[str, Callable] = "mean"):
        from xugrid_tpu.ugrid.ugrid1d import Ugrid1d

        instance = cls.__new__(cls)
        instance._weights = cls._weights_from_dataset(weights)
        instance._padded = None
        instance._target = _convert_target(setup_grid(target))
        instance._source = Network1d(Ugrid1d.from_dataset(weights, "__source"))
        instance._setup_regrid(method)
        return instance
