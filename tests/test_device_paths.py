"""
What the GPU path relies on, checked where there is no GPU:

* no float32 product on the device path may run in TF32: every
  dot_general that the CG solvers lower carries HIGHEST precision, and
  the nearest-neighbour kernel has no dot at all;
* ``_ensure_devices`` never moves a run to virtual CPU devices unless
  the caller asked for the CPU;
* ``chip_smoke``'s phases run end to end at a tiny size, and its
  ``main`` refuses a machine without a GPU.

Tests marked ``gpu`` compare the device paths with their CPU references
on a card and skip elsewhere.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xugrid_tpu.spatial import nearest
from xugrid_tpu.ugrid import interpolate


def _dot_precisions(hlo: str):
    """Precision config of every dot_general in StableHLO text."""
    ops = [line for line in hlo.splitlines() if "dot_general" in line]
    return [re.findall(r"precision = \[([A-Z, ]*)\]", op) for op in ops]


def _path_laplacian(n):
    lo = np.arange(1, n)
    hi = np.arange(n - 1)
    rows = np.concatenate([lo, hi, np.arange(n)])
    cols = np.concatenate([lo - 1, hi + 1, np.arange(n)])
    vals = np.concatenate(
        [np.full(n - 1, -1.0), np.full(n - 1, -1.0), np.full(n, 4.0)]
    )
    return rows, cols, vals, np.full(n, 4.0)


def test_nearest_kernel_has_no_dot():
    n_tiles = 2
    q = jax.ShapeDtypeStruct((16, 2), jnp.float32)
    s = jax.ShapeDtypeStruct((n_tiles * nearest.TILE, 2), jnp.float32)
    hlo = nearest._nearest_device.lower(q, q, s, s, n_tiles).as_text()
    assert "dot_general" not in hlo


@pytest.mark.parametrize("n_rhs", [1, 3])
def test_coo_cg_dots_are_highest_precision(n_rhs):
    rows, cols, vals, diag = _path_laplacian(16)
    b = np.ones((n_rhs, 16)) if n_rhs > 1 else np.ones(16)
    solve = interpolate._make_pcg_coo()
    hlo = solve.lower(
        rows, cols, vals, diag, b, np.zeros_like(b), 0.0, 1e-6, 6.0,
        maxiter=10, degree=4,
    ).as_text()
    precisions = _dot_precisions(hlo)
    assert precisions, "expected the CG inner products as dot_general"
    assert all(p == ["HIGHEST, HIGHEST"] for p in precisions), precisions


def test_dia_cg_dots_are_highest_precision():
    n = 16
    solve = interpolate._make_pcg_dia()
    hlo = solve.lower(
        np.zeros((2, n)), np.full(n, 4.0), np.ones(n), np.zeros(n), 1.0,
        0.0, 1e-6, 6.0, offsets=(-1, 1), m_pad=1, maxiter=10, degree=4,
    ).as_text()
    precisions = _dot_precisions(hlo)
    assert precisions
    assert all(p == ["HIGHEST, HIGHEST"] for p in precisions), precisions


def test_sharded_cg_dots_are_highest_precision(monkeypatch):
    from jax.sharding import Mesh

    from xugrid_tpu.parallel import sharding

    captured = []
    real_jit = jax.jit

    def spy_jit(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)

        def call(*a):
            captured.append(jitted.lower(*a).as_text())
            return jitted(*a)

        return call

    monkeypatch.setattr(sharding.jax, "jit", spy_jit)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    n = 32
    idx = np.stack([np.arange(n) - 1, np.arange(n) + 1], axis=1)
    idx[idx >= n] = -1
    w = np.where(idx >= 0, -1.0, 0.0)
    x, _ = sharding.sharded_cg_solve(
        mesh, idx, w, np.full(n, 4.0), np.ones(n), atol=1e-10
    )
    assert np.isfinite(x).all()
    precisions = _dot_precisions(captured[-1])
    assert precisions
    assert all(p == ["HIGHEST, HIGHEST"] for p in precisions), precisions


def test_ensure_devices_refuses_silent_cpu_fallback(monkeypatch):
    import __graft_entry__ as g

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    n_before = len(jax.devices())
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        g._ensure_devices(n_before + 1)
    # The backend was left alone.
    assert len(jax.devices()) == n_before


def test_ensure_devices_returns_when_enough(monkeypatch):
    import __graft_entry__ as g

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    assert g._ensure_devices(len(jax.devices())) is jax


# -- chip_smoke rehearsal ----------------------------------------------------
@pytest.fixture(scope="module")
def tiny_case():
    import chip_smoke

    return chip_smoke.make_regrid_case(n_side=40, t_side=17, n_extra=3)


def test_chip_smoke_regrid_phase(tiny_case, capsys):
    import chip_smoke

    chip_smoke.phase_regrid(*tiny_case)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split('"')[3] for line in lines] == [
        "regrid_mean", "regrid_maximum", "regrid_median",
        "regrid_centroid_locator",
    ]


def test_chip_smoke_nearest_phase(tiny_case):
    import chip_smoke

    chip_smoke.phase_nearest(tiny_case[0], n_queries=500)


def test_chip_smoke_laplace_phase():
    import chip_smoke

    chip_smoke.phase_laplace(n_side=30)


def test_chip_smoke_partition_phase(tiny_case):
    import chip_smoke

    grid, _, uda = tiny_case
    chip_smoke.phase_partition(grid, uda)


def test_chip_smoke_four_device_phase():
    import chip_smoke

    chip_smoke.phase_four(n_side=30, t_side=13)


def test_chip_smoke_reference_catches_a_wrong_result(tiny_case):
    """The host reference is independent: a perturbed result fails."""
    import chip_smoke

    grid, target, uda = tiny_case
    import xugrid_tpu as xu

    regridder = xu.OverlapRegridder(uda, target, method="maximum")
    csr = regridder._weights
    idx, wts = chip_smoke.windows_from_csr(csr.indptr, csr.indices, csr.data)
    source = np.asarray(uda.values)
    want = chip_smoke.reference_reduce("maximum", idx, wts, source)
    got = np.asarray(regridder.regrid(uda).values).reshape(want.shape)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    mean = chip_smoke.reference_reduce("mean", idx, wts, source)
    assert not np.allclose(mean, want, equal_nan=True)


def test_chip_smoke_main_refuses_cpu(capsys):
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
    # x64 stays as the test session set it.
    assert jax.config.read("jax_enable_x64")


# -- on the card -------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("method", ["mean", "maximum", "median"])
def test_regrid_on_gpu_matches_host_reference(gpu, method):
    import chip_smoke
    import xugrid_tpu as xu

    grid, target, uda = chip_smoke.make_regrid_case(
        n_side=200, t_side=97, n_extra=5
    )
    regridder = xu.OverlapRegridder(uda, target, method=method)
    csr = regridder._weights
    idx, wts = chip_smoke.windows_from_csr(csr.indptr, csr.indices, csr.data)
    want = chip_smoke.reference_reduce(
        method, idx, wts, np.asarray(uda.values)
    )
    got = np.asarray(regridder.regrid(uda).values).reshape(want.shape)
    # float32 sources accumulate in float32 on the card.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_laplace_on_gpu_matches_direct_solve(gpu):
    import chip_smoke

    grid = chip_smoke.delaunay_grid(4000)
    conn = grid.get_connectivity_matrix(grid.node_dimension, xy_weights=True)
    rng = np.random.default_rng(3)
    x, y = grid.node_coordinates.T
    data = np.sin(x / 7.0) + np.cos(y / 5.0)
    data[rng.random(grid.n_node) < 0.3] = np.nan
    got = interpolate.laplace_interpolate(data, conn, atol=1e-10)
    want = interpolate.laplace_interpolate(data, conn, direct_solve=True)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


@pytest.mark.gpu
def test_nearest_on_gpu_matches_kdtree(gpu, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("XUGRID_TPU_NEAREST", "device")
    grid, _, _ = chip_smoke.make_regrid_case(n_side=300, t_side=10)
    chip_smoke.phase_nearest(grid, n_queries=4096)
