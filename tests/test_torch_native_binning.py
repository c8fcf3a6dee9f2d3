"""Port parity: the native host binner (``lightgbm_tpu_torch/native``).

``greedy_find_bounds``, ``bin_numeric_column`` and ``bin_matrix`` must give
the bounds and bins of the port's NumPy plain versions bit for bit, and
the JAX package's (``find_bin_mappers``, ``Dataset._bin_all_columns``), on
randomized inputs: float32 and float64, NaN, zeros, heavy values,
``use_missing`` / ``zero_as_missing``, forced bounds, strided views. A
failed build raises with the compiler's message.
"""
import jax  # noqa: F401  (the JAX package runs on the CPU, see conftest)
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import binning as ref_binning
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.io import binning
from lightgbm_tpu_torch.io.binning import (BinMapper,
                                           _distinct_with_counts,
                                           _greedy_find_distinct_bounds,
                                           _greedy_find_distinct_bounds_plain)


def _samples(kind, seed):
    rng = np.random.default_rng(seed)
    n = 60_000
    if kind == "continuous":
        return rng.normal(size=n)
    if kind == "heavy":
        v = rng.normal(size=n)
        v[rng.random(n) < 0.4] = 1.25
        v[rng.random(n) < 0.2] = -3.5
        return v
    if kind == "discrete":
        return rng.integers(0, 37, size=n).astype(np.float64)
    v = rng.normal(size=n)                      # zeros and NaN
    v[rng.random(n) < 0.3] = 0.0
    v[rng.random(n) < 0.1] = np.nan
    return v


KINDS = ("continuous", "heavy", "discrete", "zeros_nan")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_bin", [15, 63, 255])
def test_greedy_bounds_native_equals_plain(kind, max_bin):
    vals = _samples(kind, 0)
    finite = vals[~np.isnan(vals)]
    for side in (finite[finite > 0], -finite[finite < 0]):
        dv, cnt = _distinct_with_counts(np.sort(side))
        for mdib in (0, 3, 50):
            nat = _greedy_find_distinct_bounds(dv, cnt, max_bin, len(side),
                                               mdib)
            plain = _greedy_find_distinct_bounds_plain(
                dv, cnt, max_bin, len(side), mdib)
            assert np.array_equal(np.asarray(nat), np.asarray(plain))
            with_ref = ref_binning._greedy_find_distinct_bounds(
                dv, cnt, max_bin, len(side), mdib)
            assert np.array_equal(np.asarray(nat), np.asarray(with_ref))


def test_greedy_bounds_empty_and_tiny():
    for dv in (np.empty(0), np.array([1.5]), np.array([1.0, 2.0, 4.0])):
        cnt = np.full(len(dv), 7, np.int64)
        assert (_greedy_find_distinct_bounds(dv, cnt, 255, int(cnt.sum()), 3)
                == _greedy_find_distinct_bounds_plain(
                    dv, cnt, 255, int(cnt.sum()), 3))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("use_missing,zero_as_missing",
                         [(True, False), (True, True), (False, False)])
def test_bin_numeric_column_equals_plain(kind, use_missing,
                                         zero_as_missing):
    vals = _samples(kind, 1)
    m = BinMapper.from_sample(vals[:20_000], 20_000, 255, 3, use_missing,
                              zero_as_missing)
    for v in (vals, vals.astype(np.float32)):
        nat = m.values_to_bins(v)
        assert nat.dtype == np.int32
        np.testing.assert_array_equal(
            nat, m.values_to_bins_plain(v.astype(np.float64)))


def test_bin_numeric_column_strided_inf_and_forced():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(50_000, 4)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:5, 1] = [np.inf, -np.inf, 0.0, -0.0, 1e-40]
    m = BinMapper.from_sample(X[:20_000, 1].astype(np.float64), 20_000, 63,
                              3, True, False, forced_bounds=[-1.0, 0.25, 2])
    col = X[:, 1]                                  # strided view
    assert col.strides[0] == 16
    np.testing.assert_array_equal(m.values_to_bins(col),
                                  m.values_to_bins_plain(col))
    # a bound itself lands in its own bin, as in searchsorted(side=left)
    ub = m.bin_upper_bound[:-1]
    np.testing.assert_array_equal(m.values_to_bins(ub),
                                  m.values_to_bins_plain(ub))


def _mixed(n, F, seed, f32=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    X[rng.random(n) < 0.1, 1] = np.nan
    X[rng.random(n) < 0.4, 2] = 0.0
    X[:, 3] = rng.integers(0, 12, size=n)          # categorical
    X[:, 4] = np.round(X[:, 4] * 2)
    X[:7, 0] = [np.inf, -np.inf, 0.0, -0.0, np.nan, 1e30, -1e30]
    return X.astype(np.float32) if f32 else X


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("params", [{}, {"zero_as_missing": True},
                                    {"use_missing": False},
                                    {"max_bin": 31, "min_data_in_bin": 1}])
def test_dataset_native_pass_equals_plain_and_reference(f32, params):
    X = _mixed(70_001, 6, 3, f32)                  # > 65,536 rows: bin_matrix
    params = dict(params, bin_construct_sample_cnt=20_000)
    port = lgt.Dataset(X, categorical_feature=[3], params=params).construct()
    assert X.flags.c_contiguous and port.binned.dtype == np.uint8
    plain = np.stack([port.bin_mappers[f].values_to_bins_plain(
        X[:, f].astype(np.float64)) for f in port.used_features], axis=1)
    np.testing.assert_array_equal(port.binned, plain)
    ref = lgb.Dataset(X, categorical_feature=[3], params=params).construct()
    assert port.used_features == ref.used_features
    np.testing.assert_array_equal(port.binned, np.asarray(ref.binned))
    for a, b in zip(port.bin_mappers, ref.bin_mappers):
        assert a.num_bin == b.num_bin and a.missing_type == b.missing_type
        if a.bin_upper_bound is not None:
            np.testing.assert_array_equal(a.bin_upper_bound,
                                          b.bin_upper_bound)


def test_mappers_equal_reference_find_bin_mappers():
    X = _mixed(30_000, 6, 4)
    forced = {0: [-1.0, 0.5], 2: [0.0, 0.75]}
    port = binning.find_bin_mappers(X, 255, categorical_features=[3],
                                    forced_bins=forced, sample_cnt=10_000)
    ref = ref_binning.find_bin_mappers(X, 255, categorical_features=[3],
                                       forced_bins=forced, sample_cnt=10_000)
    for a, b in zip(port, ref):
        assert (a.bin_type, a.num_bin, a.missing_type, a.default_bin) == \
            (b.bin_type, b.num_bin, b.missing_type, b.default_bin)
        if a.bin_upper_bound is not None:
            np.testing.assert_array_equal(a.bin_upper_bound,
                                          b.bin_upper_bound)


def test_float32_binned_in_place_without_copy(monkeypatch):
    """A dense float32 matrix reaches the native pass itself: no float64
    copy of the whole matrix is made."""
    X = _mixed(70_000, 5, 5, f32=True)
    seen = []
    real = lgt.Dataset._bin_matrix_native

    def spy(self, M, *a, **k):
        seen.append(M)
        return real(self, M, *a, **k)

    monkeypatch.setattr(lgt.Dataset, "_bin_matrix_native", spy)
    lgt.Dataset(X, params={"bin_construct_sample_cnt": 5000}).construct()
    assert len(seen) == 1 and seen[0] is X


def test_failed_build_raises_with_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match=r"broken\.cpp.*error"):
        native.build("broken")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="could not run"):
        native.build("broken")
    assert not list((tmp_path / "out").glob("*.so"))


def test_build_is_keyed_on_source(tmp_path, monkeypatch):
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int k() { return 1; }\n')
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    first = native.build("k")
    src.write_text('extern "C" int k() { return 2; }\n')
    second = native.build("k")
    assert first != second and first.exists() and second.exists()
    assert native.build("k") == second
