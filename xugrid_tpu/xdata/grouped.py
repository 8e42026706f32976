"""
Grouped / windowed operations for the xdata layer: GroupBy, Rolling,
Coarsen, Weighted, and Resample objects mirroring the xarray API
surface the reference's users exercise (reductions, iteration, map).
Host-side numpy — these are analysis conveniences, not the device compute
path.
"""

from __future__ import annotations

import numpy as np

from xugrid_tpu.xdata.variable import Variable

_REDUCERS = ("mean", "sum", "min", "max", "std", "var", "median", "prod")


def _data_array():
    from xugrid_tpu.xdata.dataarray import DataArray

    return DataArray


def _coarsen_coord(cvar, dim, k, n):
    """Coarsen one coordinate Variable along ``dim`` with window ``k``.

    The data dimension has already been trimmed/padded to ``n`` (a
    multiple of ``k``); coordinates are nan-mean-pooled to match
    (xarray's ``coord_func="mean"``), handling datetime64/timedelta64
    via their int64 representation.
    """
    import warnings

    axis = cvar.dims.index(dim)
    vals = np.asarray(cvar.data)
    is_time = vals.dtype.kind in "mM"
    time_dtype = vals.dtype
    if is_time:
        fvals = vals.astype("int64").astype(np.float64)
        fvals[np.isnat(vals)] = np.nan
    else:
        fvals = vals.astype(np.float64)
    cur = fvals.shape[axis]
    if cur > n:
        index = [slice(None)] * fvals.ndim
        index[axis] = slice(0, n)
        fvals = fvals[tuple(index)]
    elif cur < n:
        pad = [(0, 0)] * fvals.ndim
        pad[axis] = (0, n - cur)
        fvals = np.pad(fvals, pad, constant_values=np.nan)
    shape = fvals.shape[:axis] + (n // k, k) + fvals.shape[axis + 1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        pooled = np.nanmean(fvals.reshape(shape), axis=axis + 1)
    if is_time:
        pooled = np.where(np.isnan(pooled), np.iinfo("int64").min, pooled)
        pooled = pooled.astype("int64").view(time_dtype).reshape(pooled.shape)
    return Variable(cvar.dims, pooled, cvar.attrs)


# ---------------------------------------------------------------------------
# GroupBy
# ---------------------------------------------------------------------------
class DataArrayGroupBy:
    """Group a DataArray by a 1-D coordinate/array over its dimension."""

    def __init__(self, obj, group):
        DataArray = _data_array()
        self._obj = obj
        if isinstance(group, str):
            self._group_name = group
            key = obj._coords[group]
        elif isinstance(group, DataArray):
            self._group_name = group.name or "group"
            key = group.variable
        else:
            raise TypeError("groupby expects a coordinate name or DataArray")
        if len(key.dims) != 1:
            raise ValueError("groupby requires a 1-D group key")
        self._dim = key.dims[0]
        values = np.asarray(key.data)
        self._labels, self._inverse = np.unique(values, return_inverse=True)
        self._inverse = self._inverse.ravel()

    def __len__(self):
        return len(self._labels)

    def __iter__(self):
        for k, label in enumerate(self._labels):
            yield label, self._obj.isel(
                {self._dim: np.flatnonzero(self._inverse == k)}
            )

    def map(self, func, *args, **kwargs):
        from xugrid_tpu.xdata import concat

        results = [func(sub, *args, **kwargs) for _, sub in self]
        if all(np.ndim(getattr(r, "data", r)) == 0 for r in results):
            # np.stack (not float()) so datetime64/int results keep
            # their dtype (first/last on time data).
            return self._wrap_scalars(
                np.stack(
                    [np.asarray(getattr(r, "data", r)) for r in results]
                )
            )
        out = concat(results, dim=self._dim)
        # When the group dim survives intact (transform-like results),
        # restore the original element order — concat emits groups in
        # label-sorted order (xarray's _maybe_reorder).
        if out.sizes.get(self._dim) == len(self._inverse):
            grouped_pos = np.concatenate(
                [
                    np.flatnonzero(self._inverse == k)
                    for k in range(len(self._labels))
                ]
            )
            order = np.argsort(grouped_pos, kind="stable")
            out = out.isel({self._dim: order})
        return out

    def _wrap_scalars(self, values):
        DataArray = _data_array()
        var = Variable((self._group_name,), np.asarray(values))
        coords = {self._group_name: Variable((self._group_name,), self._labels)}
        return DataArray._construct(var, coords, self._obj.name)

    def _reduce(self, func_name, **kwargs):
        DataArray = _data_array()
        obj = self._obj
        axis = obj.dims.index(self._dim)
        data = np.asarray(obj.data)
        if data.dtype.kind == "f":
            # NaN-skipping only matters for inexact input; ints/bools/
            # datetimes go through the plain reducer so sum/min/max keep
            # their dtype (xarray behavior) and datetime64 reduces
            # instead of raising on a float cast.
            data = data.astype(np.float64)
            func = getattr(np, f"nan{func_name}")
        else:
            func = getattr(np, func_name)
        moved = np.moveaxis(data, axis, 0)
        pieces = []
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for k in range(len(self._labels)):
                sub = moved[self._inverse == k]
                pieces.append(func(sub, axis=0, **kwargs))
        stacked = np.stack(pieces, axis=0)
        result = np.moveaxis(stacked, 0, axis)
        new_dims = tuple(
            self._group_name if d == self._dim else d for d in obj.dims
        )
        coords = {
            k: v
            for k, v in obj._coords.items()
            if self._dim not in v.dims
        }
        coords[self._group_name] = Variable(
            (self._group_name,), self._labels
        )
        var = Variable(new_dims, result, obj.attrs)
        return DataArray._construct(var, coords, obj.name)

    def _dispatch_reduce(self, name, dim, **kwargs):
        """xarray groupby-reduce semantics over an explicit ``dim``:
        the group dim (or None) collapses to one value per label; other
        dims reduce inside each group, transform-like; Ellipsis or a
        list containing the group dim reduces everything requested
        within each group at once."""
        group_dims = (None, self._dim, self._group_name)
        if dim in group_dims:
            if name == "count":
                return self._count_groupwise()
            return self._reduce(name, **kwargs)
        if dim is Ellipsis:
            return self.map(lambda sub: getattr(sub, name)(**kwargs))
        dims = [dim] if isinstance(dim, str) else list(dim)
        if self._dim in dims or self._group_name in dims:
            inner = [
                d for d in dims
                if d not in (self._dim, self._group_name)
            ]
            return self.map(
                lambda sub: getattr(sub, name)(
                    inner + [self._dim], **kwargs
                )
            )
        return self.map(
            lambda sub: getattr(sub, name)(
                dims[0] if len(dims) == 1 else dims, **kwargs
            )
        )

    def count(self, dim=None):
        return self._dispatch_reduce("count", dim)

    def _count_groupwise(self):
        DataArray = _data_array()
        obj = self._obj
        axis = obj.dims.index(self._dim)
        data = np.asarray(obj.data)
        if data.dtype.kind in "fc":
            valid = ~np.isnan(data)
        elif data.dtype.kind in "mM":
            valid = ~np.isnat(data)
        else:
            valid = np.ones(data.shape, bool)
        moved = np.moveaxis(valid, axis, 0)
        pieces = [
            moved[self._inverse == k].sum(axis=0)
            for k in range(len(self._labels))
        ]
        stacked = np.moveaxis(np.stack(pieces, axis=0), 0, axis)
        new_dims = tuple(
            self._group_name if d == self._dim else d for d in obj.dims
        )
        coords = {
            k: v for k, v in obj._coords.items() if self._dim not in v.dims
        }
        coords[self._group_name] = Variable(
            (self._group_name,), self._labels
        )
        return DataArray._construct(
            Variable(new_dims, stacked.astype(np.int64)), coords, obj.name
        )

    def first(self):
        return self.map(lambda sub: sub.isel({self._dim: 0}))

    def last(self):
        return self.map(lambda sub: sub.isel({self._dim: -1}))


for _name in _REDUCERS:
    def _make(n):
        def method(self, dim=None, **kwargs):
            return self._dispatch_reduce(n, dim, **kwargs)

        method.__name__ = n
        return method

    setattr(DataArrayGroupBy, _name, _make(_name))


class DatasetGroupBy:
    def __init__(self, ds, group):
        self._ds = ds
        self._group = group

    def _apply(self, method_name, *args, **kwargs):
        from xugrid_tpu.xdata.dataset import Dataset

        out = Dataset(attrs=dict(self._ds.attrs))
        key = self._ds[self._group] if isinstance(self._group, str) else self._group
        dim = key.dims[0]
        for name in self._ds.data_vars:
            da = self._ds[name]
            if dim in da.dims:
                grouped = da.groupby(self._group if isinstance(self._group, str) and self._group in da._coords else key)
                out[name] = getattr(grouped, method_name)(*args, **kwargs)
            else:
                out[name] = da
        return out

    def __iter__(self):
        key = self._ds[self._group] if isinstance(self._group, str) else self._group
        dim = key.dims[0]
        labels, inverse = np.unique(np.asarray(key.data), return_inverse=True)
        for k, label in enumerate(labels):
            yield label, self._ds.isel(
                {dim: np.flatnonzero(inverse.ravel() == k)}
            )


for _name in _REDUCERS + ("count", "first", "last"):
    def _make_ds(n):
        def method(self, *args, **kwargs):
            return self._apply(n, *args, **kwargs)

        method.__name__ = n
        return method

    setattr(DatasetGroupBy, _name, _make_ds(_name))


# ---------------------------------------------------------------------------
# Rolling
# ---------------------------------------------------------------------------
class DataArrayRolling:
    """Rolling windows over one or more dimensions (NaN-padded edges;
    reductions run over the full window product, xarray semantics)."""

    def __init__(self, obj, windows, min_periods=None, center=False):
        if not windows:
            raise ValueError("rolling requires at least one dimension")
        self._obj = obj
        self._windows_map = dict(windows)
        total = int(np.prod(list(self._windows_map.values())))
        self._min_periods = total if min_periods is None else min_periods
        self._center = center

    def _windows(self):
        """(windowed array, window-axis count); the trailing axes are
        the per-dim window axes in insertion order."""
        obj = self._obj
        data = np.asarray(obj.data, dtype=np.float64)
        for dim, w in self._windows_map.items():
            axis = obj.dims.index(dim)
            if self._center:
                pad_l = (w - 1) // 2
                pad_r = w - 1 - pad_l
            else:
                pad_l, pad_r = w - 1, 0
            pad = [(0, 0)] * data.ndim
            pad[axis] = (pad_l, pad_r)
            # previously appended window axes ride along untouched
            pad += [(0, 0)] * (data.ndim - len(pad))
            data = np.pad(data, pad, constant_values=np.nan)
            data = np.lib.stride_tricks.sliding_window_view(
                data, w, axis=axis
            )
        return data, len(self._windows_map)

    def _axes(self):
        return tuple(self._obj.dims.index(d) for d in self._windows_map)

    def _reduce(self, func_name):
        DataArray = _data_array()
        obj = self._obj
        win, n_win = self._windows()
        wax = tuple(range(win.ndim - n_win, win.ndim))
        func = getattr(np, f"nan{func_name}")
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            result = func(win, axis=wax)
            counts = np.sum(~np.isnan(win), axis=wax)
        result = np.where(counts >= self._min_periods, result, np.nan)
        var = Variable(obj.dims, result, obj.attrs)
        return DataArray._construct(var, dict(obj._coords), obj.name)

    def count(self):
        DataArray = _data_array()
        obj = self._obj
        win, n_win = self._windows()
        wax = tuple(range(win.ndim - n_win, win.ndim))
        counts = np.sum(~np.isnan(win), axis=wax)
        var = Variable(obj.dims, counts.astype(np.float64))
        return DataArray._construct(var, dict(obj._coords), obj.name)

    def construct(self, window_dim):
        DataArray = _data_array()
        obj = self._obj
        if isinstance(window_dim, str):
            if len(self._windows_map) != 1:
                raise ValueError(
                    "construct with multiple rolling dims needs a "
                    "mapping of dim -> window_dim"
                )
            names = [window_dim]
        else:
            names = [window_dim[d] for d in self._windows_map]
        win, _ = self._windows()
        dims = obj.dims + tuple(names)
        var = Variable(dims, win)
        return DataArray._construct(var, dict(obj._coords), obj.name)


for _name in _REDUCERS:
    def _make_roll(n):
        def method(self, **kwargs):
            return self._reduce(n)

        method.__name__ = n
        return method

    setattr(DataArrayRolling, _name, _make_roll(_name))


# ---------------------------------------------------------------------------
# Coarsen
# ---------------------------------------------------------------------------
class DataArrayCoarsen:
    def __init__(self, obj, windows, boundary="exact"):
        self._obj = obj
        self._windows = dict(windows)
        self._boundary = boundary

    def _reduce(self, func_name):
        DataArray = _data_array()
        obj = self._obj
        data = np.asarray(obj.data)
        # boundary="pad" introduces NaN fill, which needs float; exact/
        # trim windows of non-float input reduce in their own dtype so
        # integer sum/min/max stay integer (xarray behavior).
        needs_float = data.dtype.kind == "f" or self._boundary == "pad"
        if needs_float:
            data = data.astype(np.float64)
        coords = dict(obj._coords)
        for dim, k in self._windows.items():
            axis = obj.dims.index(dim)
            n = data.shape[axis]
            if n % k:
                if self._boundary == "exact":
                    raise ValueError(
                        f"dimension {dim!r} size {n} is not a multiple "
                        f"of window {k}"
                    )
                if self._boundary == "trim":
                    index = [slice(None)] * data.ndim
                    index[axis] = slice(0, n - n % k)
                    data = data[tuple(index)]
                    n = data.shape[axis]
                elif self._boundary == "pad":
                    pad = [(0, 0)] * data.ndim
                    pad[axis] = (0, k - n % k)
                    data = np.pad(data, pad, constant_values=np.nan)
                    n = data.shape[axis]
            shape = (
                data.shape[:axis] + (n // k, k) + data.shape[axis + 1:]
            )
            func = getattr(np, f"nan{func_name}" if needs_float else func_name)
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                data = func(data.reshape(shape), axis=axis + 1)
            # coarsen EVERY coordinate containing this dim (not just the
            # index coordinate) with a nan-mean so every boundary mode
            # yields exactly n // k entries along the dim (xarray's
            # coord_func="mean" behavior)
            for cname, cvar in list(coords.items()):
                if dim not in cvar.dims:
                    continue
                coords[cname] = _coarsen_coord(cvar, dim, k, n)
        var = Variable(obj.dims, data, obj.attrs)
        out = _data_array()._construct(var, coords, obj.name)
        return out


for _name in _REDUCERS:
    def _make_coarse(n):
        def method(self, **kwargs):
            return self._reduce(n)

        method.__name__ = n
        return method

    setattr(DataArrayCoarsen, _name, _make_coarse(_name))


# ---------------------------------------------------------------------------
# Weighted
# ---------------------------------------------------------------------------
class DataArrayWeighted:
    def __init__(self, obj, weights):
        self._obj = obj
        self._weights = weights

    def _aligned(self):
        obj, w = self._obj, self._weights
        wb = w.broadcast_like(obj)
        data = np.asarray(obj.data, dtype=np.float64)
        wd = np.asarray(wb.data, dtype=np.float64)
        valid = ~np.isnan(data)
        wd = np.where(valid, wd, 0.0)
        return data, wd, valid

    def _axes(self, dim):
        if dim is None:
            return None
        dims = [dim] if isinstance(dim, str) else list(dim)
        return tuple(self._obj.dims.index(d) for d in dims)

    def _wrap(self, result, dim):
        DataArray = _data_array()
        obj = self._obj
        if dim is None:
            new_dims = ()
        else:
            dims = [dim] if isinstance(dim, str) else list(dim)
            new_dims = tuple(d for d in obj.dims if d not in dims)
        coords = {
            k: v
            for k, v in obj._coords.items()
            if set(v.dims) <= set(new_dims)
        }
        return DataArray._construct(
            Variable(new_dims, result), coords, obj.name
        )

    def sum(self, dim=None, skipna=True):
        data, wd, valid = self._aligned()
        axes = self._axes(dim)
        return self._wrap(
            np.sum(np.where(valid, data, 0.0) * wd, axis=axes), dim
        )

    def sum_of_weights(self, dim=None):
        _, wd, _ = self._aligned()
        return self._wrap(np.sum(wd, axis=self._axes(dim)), dim)

    def mean(self, dim=None, skipna=True):
        data, wd, valid = self._aligned()
        axes = self._axes(dim)
        num = np.sum(np.where(valid, data, 0.0) * wd, axis=axes)
        den = np.sum(wd, axis=axes)
        return self._wrap(
            np.where(den > 0, num / np.where(den == 0, 1.0, den), np.nan),
            dim,
        )

    def var(self, dim=None, skipna=True):
        data, wd, valid = self._aligned()
        axes = self._axes(dim)
        den = np.sum(wd, axis=axes)
        mean = np.sum(np.where(valid, data, 0.0) * wd, axis=axes)
        mean = np.where(den > 0, mean / np.where(den == 0, 1.0, den), np.nan)
        mean_b = np.expand_dims(mean, axes) if axes else mean
        dev = np.where(valid, (data - mean_b) ** 2, 0.0)
        num = np.sum(dev * wd, axis=axes)
        return self._wrap(
            np.where(den > 0, num / np.where(den == 0, 1.0, den), np.nan),
            dim,
        )

    def std(self, dim=None, skipna=True):
        out = self.var(dim=dim, skipna=skipna)
        return out._apply_unary(np.sqrt)


# ---------------------------------------------------------------------------
# Resample (time frequencies via pandas)
# ---------------------------------------------------------------------------
#: offset aliases removed in pandas >= 2.2/3.0, mapped to their
#: replacements so user code written against older pandas keeps working.
_LEGACY_FREQ_ALIASES = {
    "H": "h", "T": "min", "S": "s", "L": "ms", "U": "us", "N": "ns",
    "M": "ME", "Q": "QE", "A": "YE", "Y": "YE",
    "BM": "BME", "BQ": "BQE", "BA": "BYE", "BY": "BYE",
}


def _resample_bin_labels(times, freq):
    """Per-element bin label using pandas' own resample binning
    (pd.Grouper) — covers every pandas offset alias, including anchored
    ones (QS, W-SUN, YS) that ``to_period`` rejects, with the label
    conventions xarray users expect (e.g. month-END labels for "ME").

    Returns ``(labels, full_bins)``: per-element labels plus the FULL
    regular bin range including empty bins (pandas/xarray resample
    emits NaN rows for gaps; observed groups alone would silently
    misalign position-based consumers)."""
    import re

    import pandas as pd

    def grouper_bins(f):
        s = pd.Series(np.zeros(len(times)), index=times)
        idx = s.groupby(pd.Grouper(freq=f)).indices
        full = s.resample(f).size().index
        return idx, full

    try:
        idx, full = grouper_bins(freq)
    except ValueError:
        m = re.match(r"^(\d*)([A-Za-z]+)(-\w+)?$", str(freq))
        alias = _LEGACY_FREQ_ALIASES.get(m.group(2)) if m else None
        if alias is None:
            raise
        idx, full = grouper_bins(
            (m.group(1) or "") + alias + (m.group(3) or "")
        )
    labels = np.empty(len(times), dtype="datetime64[ns]")
    for lab, pos in idx.items():
        labels[np.asarray(pos)] = np.datetime64(lab)
    return labels, np.asarray(full, dtype="datetime64[ns]")


class DataArrayResample:
    def __init__(self, obj, dim, freq):
        import pandas as pd

        self._obj = obj
        self._dim = dim
        times = pd.to_datetime(np.asarray(obj._coords[dim].data))
        self._bins, self._full_bins = _resample_bin_labels(times, freq)
        DataArray = _data_array()
        self._key = DataArray(
            np.asarray(self._bins), dims=(dim,), name=dim
        )

    def _grouped(self):
        return DataArrayGroupBy(self._obj, self._key)

    def __iter__(self):
        return iter(self._grouped())

    def __getattr__(self, name):
        if name in _REDUCERS + ("count", "first", "last", "map"):
            grouped = self._grouped()

            def method(*args, **kwargs):
                out = getattr(grouped, name)(*args, **kwargs)
                if grouped._group_name != self._dim:
                    out = out.rename({grouped._group_name: self._dim})
                # Emit the FULL regular bin range: empty bins take NaN
                # (0 for count), matching pandas/xarray resample.
                if (
                    self._dim in out.dims
                    and out.sizes[self._dim] < len(self._full_bins)
                ):
                    fill = 0 if name == "count" else np.nan
                    out = out.reindex(
                        {self._dim: self._full_bins}, fill_value=fill
                    )
                return out

            return method
        raise AttributeError(name)


# ---------------------------------------------------------------------------
# Dataset windowed dispatch (rolling / coarsen / resample per variable)
# ---------------------------------------------------------------------------
class DatasetWindowed:
    """Applies a DataArray windowing op (rolling/coarsen/resample) to
    every data variable carrying the windowed dimension."""

    def __init__(self, ds, kind, windows, options):
        self._ds = ds
        self._kind = kind
        self._windows = dict(windows)
        self._options = dict(options)

    def _reduce(self, method_name, *args, **kwargs):
        from xugrid_tpu.xdata.dataset import Dataset

        dims = list(self._windows)
        out = Dataset(attrs=dict(self._ds.attrs))
        for name in self._ds.data_vars:
            da = self._ds[name]
            if not any(d in da.dims for d in dims):
                out._variables[name] = self._ds._variables[name]
                continue
            sub_windows = {
                d: w for d, w in self._windows.items() if d in da.dims
            }
            if self._kind == "rolling":
                obj = da.rolling(sub_windows, **self._options)
            elif self._kind == "coarsen":
                obj = da.coarsen(sub_windows, **self._options)
            else:  # resample
                obj = da.resample(sub_windows)
            out._set_variable(name, getattr(obj, method_name)(*args, **kwargs))
        sizes = out.dims_sizes()
        for k in self._ds._coord_names:
            if k in out._variables:
                out._coord_names.add(k)
                continue
            var = self._ds._variables[k]
            if all(sizes.get(d) == s for d, s in var.sizes.items()):
                out._variables[k] = var
                out._coord_names.add(k)
        return out

    def __getattr__(self, name):
        if name in _REDUCERS + ("count", "first", "last"):
            def method(*args, **kwargs):
                return self._reduce(name, *args, **kwargs)

            return method
        raise AttributeError(name)
