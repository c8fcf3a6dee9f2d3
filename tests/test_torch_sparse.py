"""Port parity: scipy sparse input.

A CSR or CSC matrix is binned from CSC one column at a time, and its bin
mappers come from a sample of CSR rows, as in the reference. The checks,
on a matrix of five columns 85% zeros (NaN stored in one of them), a
categorical column and six columns of which at most one is non-zero in a
row:

- the binned bytes of a CSR and a CSC ``Dataset`` equal the dense one's
  and the reference's, with all rows sampled and with a
  ``bin_construct_sample_cnt`` below the row count (the mappers of the
  sampled CSR rows); a valid set made from CSR takes the training
  mappers and bins as the dense one does;
- training on CSR gives the dense run's model text, with and without
  EFB (the sparse columns here bundle);
- ``predict`` on CSR and CSC equals ``predict`` on the dense rows, on the
  device path, for leaf indices, and from a model loaded from text;
- the port's binning and device predict never densify more than one
  column at a time (``toarray`` / ``todense`` of a wider matrix fails
  while they run).
"""
import contextlib

import numpy as np
import pytest
import scipy.sparse as sp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

N, N_HOLD, F = 3000, 500, 12
CAT = [5]
PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "device_type": "cpu", "use_quantized_grad": True}


def sparse_data(n=N + N_HOLD, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    X[:, :5][rng.random((n, 5)) < 0.85] = 0.0
    # columns 6-11: at most one non-zero a row (they bundle)
    sel = rng.integers(0, 8, size=n)
    X[:, 6:] = np.where(sel[:, None] == np.arange(6)[None, :], X[:, 6:], 0.0)
    X[:, CAT] = np.where(rng.random((n, 1)) < 0.3,
                         rng.integers(1, 6, size=(n, 1)), 0)
    X[rng.random(n) < 0.05, 2] = np.nan
    y = (X[:, 0] + X[:, 3] - np.nan_to_num(X[:, 2]) + (X[:, 5] == 2)
         > 0).astype(np.float64)
    return X, y


@contextlib.contextmanager
def one_column_at_a_time():
    """While open, densifying a CSR or CSC matrix of more than one column
    fails."""
    saved = []
    for cls in (sp.csr_matrix, sp.csc_matrix):
        for name in ("toarray", "todense"):
            orig = cls.__dict__.get(name)
            saved.append((cls, name, orig))

            def guard(self, *a, _orig=getattr(cls, name), _name=name, **k):
                if self.shape[1] > 1:
                    raise AssertionError(f"{_name} of a {self.shape} sparse "
                                         "matrix")
                return _orig(self, *a, **k)

            setattr(cls, name, guard)
    try:
        yield
    finally:
        for cls, name, orig in saved:
            if orig is None:
                delattr(cls, name)
            else:
                setattr(cls, name, orig)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("sample_cnt", [200_000, 1000])
def test_sparse_bins_equal_dense_and_reference(fmt, sample_cnt):
    X, y = sparse_data()
    Xs = getattr(sp, f"{fmt}_matrix")(X)
    params = {"bin_construct_sample_cnt": sample_cnt}
    dense = lgt.Dataset(X, label=y, categorical_feature=CAT,
                        params=params).construct()
    with one_column_at_a_time():
        port = lgt.Dataset(Xs, label=y, categorical_feature=CAT,
                           params=params).construct()
    ref = lgb.Dataset(Xs, label=y, categorical_feature=CAT,
                      params=params).construct()
    assert port.used_features == dense.used_features == ref.used_features
    assert port.num_data == len(y)
    assert port.binned.dtype == np.uint8
    np.testing.assert_array_equal(port.binned, dense.binned)
    np.testing.assert_array_equal(port.binned, np.asarray(ref.binned))
    for a, b in zip(port.bin_mappers, ref.bin_mappers):
        assert a.num_bin == b.num_bin and a.missing_type == b.missing_type
    # a valid set from CSR bins through the training mappers
    vs = port.create_valid(sp.csr_matrix(X[:N_HOLD]), label=y[:N_HOLD])
    vd = dense.create_valid(X[:N_HOLD], label=y[:N_HOLD])
    np.testing.assert_array_equal(vs.construct().binned,
                                  vd.construct().binned)


@pytest.mark.parametrize("enable_bundle", [True, False])
def test_sparse_training_and_predict_equal_dense(enable_bundle):
    X, y = sparse_data()
    Xt, yt, Xv = X[:N], y[:N], X[N:]
    params = dict(PARAMS, enable_bundle=enable_bundle)
    bd = lgt.train(params, lgt.Dataset(Xt, label=yt,
                                       categorical_feature=CAT),
                   num_boost_round=4)
    with one_column_at_a_time():
        bs = lgt.train(params, lgt.Dataset(sp.csr_matrix(Xt), label=yt,
                                           categorical_feature=CAT),
                       num_boost_round=4)
    assert bs.engine.has_bundles == bd.engine.has_bundles == enable_bundle
    text = bs.model_to_string()
    assert text == bd.model_to_string()
    want = bd.predict(Xv)
    for fmt in ("csr", "csc"):
        Xs = getattr(sp, f"{fmt}_matrix")(Xv)
        with one_column_at_a_time():
            np.testing.assert_array_equal(bs.predict(Xs), want)
        np.testing.assert_array_equal(bs.predict(Xs, pred_leaf=True),
                                      bd.predict(Xv, pred_leaf=True))
    np.testing.assert_allclose(
        lgt.Booster(model_str=text).predict(sp.csr_matrix(Xv)), want,
        rtol=0, atol=1e-6)


def test_sparse_training_matches_reference():
    """Both packages on the same CSR input, bundled: identical split
    lines (quantized gradients: every histogram sum exact)."""
    X, y = sparse_data()
    Xs = sp.csr_matrix(X[:N])
    params = {k: v for k, v in PARAMS.items() if k != "device_type"}
    ref = lgb.train(dict(params), lgb.Dataset(Xs, label=y[:N],
                                              categorical_feature=CAT),
                    num_boost_round=4)
    port = lgt.train(dict(PARAMS), lgt.Dataset(Xs, label=y[:N],
                                               categorical_feature=CAT),
                     num_boost_round=4,
                     noise=JaxReplayNoise(Config({}).objective_seed))
    assert ref.engine.has_bundles and port.engine.has_bundles

    def lines(t):
        return [ln for ln in t.splitlines() if ln.split("=", 1)[0] in
                ("split_feature", "threshold", "decision_type")]

    assert lines(port.model_to_string()) == lines(ref.model_to_string())
    Xv = sp.csr_matrix(X[N:])
    np.testing.assert_allclose(port.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=1e-5)


def test_files_stay_refused(tmp_path):
    """Text files load (tests/test_torch_io_files.py); streamed two-round
    loading stays refused by name."""
    path = tmp_path / "train.csv"
    path.write_text("1,0.5,2\n0,1.5,3\n")
    with pytest.raises(lgt.LightGBMError, match="two_round"):
        lgt.Dataset(str(path), params={"two_round": True}).construct()
