"""Port parity: device-side ingest (``lightgbm_tpu_torch/ops/ingest.py``).

The torch route runs here on the CPU (``tpu_ingest_device=true`` with
``device_type=cpu``); its bins and feature-major ``bins_t`` must be
byte-equal to the host bins and to the JAX package's ``device_ingest``
(on jax's CPU backend) on the inputs of ``tests/test_ingest.py``: every
missing semantics, categorical features, large ids standing down, ragged
chunks, inf values, the ``_f32_exclusive`` edges, and float64 values off
the float32 grid (equal to the reference's device route). Then the
Dataset and engine wiring: the lazy host copy, the ``auto`` rule, FATAL
``true`` on a machine without a card, adoption by ``DeviceData``, and
training from ingested bins (the host-binned model's text; the
reference's split lines, on bundleable data too, where both packages
skip the EFB probe).
"""
import jax  # noqa: F401  (the JAX package runs on the CPU, see conftest)
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import binning as ref_binning
from lightgbm_tpu.ops import ingest as ref_ingest
from lightgbm_tpu_torch.boosting.gbdt import DeviceData
from lightgbm_tpu_torch.io import binning
from lightgbm_tpu_torch.io.binning import BinMapper
from lightgbm_tpu_torch.ops import ingest
from lightgbm_tpu_torch.utils import hbm
from test_torch_train import _reference_metrics_off  # noqa: F401

CPU = torch.device("cpu")


def _f32_matrix(n, f, seed=0, nan_cols=(), zero_cols=(), cat_cols=(),
                cat_card=20):
    """tests/test_ingest.py's float32-representable float64 matrix."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32).astype(np.float64)
    for c in zero_cols:
        X[:, c] = np.where(rng.uniform(size=n) < 0.3, 0.0, X[:, c])
    for c in cat_cols:
        X[:, c] = rng.integers(0, cat_card, size=n).astype(np.float64)
    for c in nan_cols:
        X[rng.uniform(size=n) < 0.1, c] = np.nan
    return X


def _both_mappers(X, **kw):
    return (binning.find_bin_mappers(X, **kw),
            ref_binning.find_bin_mappers(X, **kw))


def _host_bins(X, mappers, used):
    return np.stack([mappers[f].values_to_bins(X[:, f]).astype(np.uint8)
                     for f in used], axis=1)


def _check(X, mappers, ref_mappers, chunk_rows=1024, host_equal=True):
    """Port device bins == reference device bins (and == host bins)."""
    used = [i for i, m in enumerate(mappers) if not m.is_trivial]
    res = ingest.device_ingest(X, mappers, used, CPU,
                               chunk_rows=chunk_rows)
    bins, bins_t = res.bins.numpy(), res.bins_t.numpy()
    assert bins.dtype == np.uint8 and bins_t.dtype == np.uint8
    np.testing.assert_array_equal(bins_t, bins.T)
    ref = ref_ingest.device_ingest(X, ref_mappers, used, np.uint8,
                                   chunk_rows=chunk_rows,
                                   emit_transposed=True)
    np.testing.assert_array_equal(bins, np.asarray(ref.bins))
    np.testing.assert_array_equal(bins_t.astype(np.int8),
                                  np.asarray(ref.bins_t))
    if host_equal:
        np.testing.assert_array_equal(bins, _host_bins(X, mappers, used))
    assert res.chunks == -(-len(X) // min(chunk_rows, len(X)))
    assert res.h2d_bytes == X.shape[0] * len(used) * 4
    assert res.assign_ms is None          # device time only on a card
    return res


@pytest.mark.parametrize("use_missing", [True, False])
@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_missing_semantics(use_missing, zero_as_missing):
    X = _f32_matrix(7013, 6, seed=3, nan_cols=(1, 2), zero_cols=(2, 4))
    _check(X, *_both_mappers(X, max_bin=64, use_missing=use_missing,
                             zero_as_missing=zero_as_missing))


def test_categorical_with_negative_and_unseen():
    X = _f32_matrix(5003, 5, seed=4, nan_cols=(1,), cat_cols=(2, 3),
                    cat_card=40)
    rng = np.random.default_rng(9)
    X[rng.uniform(size=len(X)) < 0.05, 3] = -7.0
    X[rng.uniform(size=len(X)) < 0.05, 3] = 10_000.0
    X[:4, 2] = [np.nan, np.inf, -np.inf, 2.0**40]
    X[4:7, 2] = [3.7, -0.5, 1e30]               # truncation; out of range
    _check(X, *_both_mappers(X, max_bin=32, categorical_features=[2, 3]))


def test_high_cardinality_categorical():
    X = _f32_matrix(6007, 4, seed=21, cat_cols=(1,), cat_card=1500)
    _check(X, *_both_mappers(X, max_bin=255, categorical_features=[1]))


def test_large_categorical_ids_stand_down():
    X = _f32_matrix(2003, 3, seed=22, cat_cols=(2,), cat_card=10)
    X[::7, 2] = float(2**32 + 5)    # exact in f64, wraps int32 to 5
    mappers = binning.find_bin_mappers(X, max_bin=32,
                                       categorical_features=[2])
    used = [i for i, m in enumerate(mappers) if not m.is_trivial]
    assert not ingest.cat_device_safe(mappers, used)
    with pytest.raises(ValueError):
        ingest.build_tables(mappers, used)
    y = (X[:, 0] > 0).astype(float)
    p = {"tpu_ingest_device": True, "device_type": "cpu", "verbosity": -1}
    dsd = lgt.Dataset(X, label=y, categorical_feature=[2],
                      params=p).construct()
    assert dsd.device_ingested() is None
    dsh = lgt.Dataset(X, label=y, categorical_feature=[2],
                      params=dict(p, tpu_ingest_device=False)).construct()
    np.testing.assert_array_equal(dsd.binned, dsh.binned)
    ref = lgb.Dataset(X, label=y, categorical_feature=[2],
                      params={"tpu_ingest_device": True,
                              "verbosity": -1}).construct()
    np.testing.assert_array_equal(dsd.binned, np.asarray(ref.binned))


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("chunk_rows", [4096, 777])
def test_float32_input_and_ragged_chunks(f32, chunk_rows):
    X = _f32_matrix(2 * 4096 + 1234, 4, seed=5, nan_cols=(0,),
                    zero_cols=(1,))
    pm, rm = _both_mappers(X, max_bin=255)
    _check(X.astype(np.float32) if f32 else X, pm, rm,
           chunk_rows=chunk_rows)


def test_forced_bounds():
    X = _f32_matrix(3001, 3, seed=6, zero_cols=(1,))
    _check(X, *_both_mappers(X, max_bin=32,
                             forced_bins={0: [-1.0, 0.25, 1.5],
                                          2: [0.0, 0.5]}))


def test_inf_values():
    X = _f32_matrix(2003, 3, seed=7)
    X[5, 0], X[6, 0], X[7, 1] = np.inf, -np.inf, np.nan
    _check(X, *_both_mappers(X, max_bin=32))


def test_selected_columns_only():
    """Constant columns are dropped: only the used columns are read."""
    X = _f32_matrix(3000, 5, seed=8, nan_cols=(3,))
    X[:, 1] = 2.5
    pm, rm = _both_mappers(X, max_bin=64)
    res = _check(X, pm, rm)
    assert res.bins.shape == (3000, 4)


def test_f32_exclusive_edges():
    b64 = np.float64(0.1) + 1e-12        # not f32-representable
    lo = np.float32(b64)
    hi = np.nextafter(lo, np.float32(np.inf), dtype=np.float32)
    bounds = np.array([-np.inf, np.float64(np.float32(0.5)), b64, 3.0,
                       np.inf])
    np.testing.assert_array_equal(ingest._f32_exclusive(bounds),
                                  ref_ingest._f32_exclusive(bounds))
    m = BinMapper(bin_type="numerical", num_bin=2, missing_type="none",
                  bin_upper_bound=np.array([b64, np.inf]))
    excl = ingest._f32_exclusive(m.bin_upper_bound)
    for v in (lo, hi, np.float32(0.0), np.float32(1.0)):
        host = m.values_to_bins(np.array([np.float64(v)]))[0]
        dev = min(int(np.searchsorted(excl, np.float32(v), side="right")),
                  len(m.bin_upper_bound) - 1)
        assert dev == host, (v, host, dev)


def test_f64_off_the_f32_grid_equals_reference_device_route():
    """Genuine float64 values are cast to float32 on the way, as on the
    reference's device route: equal to it, not necessarily to the host."""
    rng = np.random.default_rng(10)
    X = rng.normal(size=(5000, 3))
    pm, rm = _both_mappers(X, max_bin=255)
    # values just beside the bounds, where the float32 cast decides
    ub = pm[0].bin_upper_bound[:-1]
    X[:len(ub), 0] = np.nextafter(ub, np.inf)
    X[len(ub):2 * len(ub), 0] = ub
    _check(X, pm, rm, host_equal=False)


def test_f64_off_the_f32_grid_may_land_one_bin_off_the_host():
    """The divergence the device route allows on genuine float64 input:
    a value just above a bound that rounds down to the bound's side in
    float32 bins one below the host's float64 bin, and no value lands
    further off; float32 copies of the same values bin alike on both
    routes."""
    rng = np.random.default_rng(10)
    X = rng.normal(size=(5000, 3))
    pm, rm = _both_mappers(X, max_bin=255)
    ub = pm[0].bin_upper_bound[:-1]
    X[:len(ub), 0] = np.nextafter(ub, np.inf)
    used = [0, 1, 2]
    dev = ingest.device_ingest(X, pm, used, CPU).bins.numpy()
    host = _host_bins(X, pm, used)
    diff = host.astype(np.int64) - dev.astype(np.int64)
    assert (diff[:len(ub), 0] == 1).sum() > len(ub) // 4
    assert set(np.unique(diff)) <= {0, 1}
    X32 = X.astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(
        ingest.device_ingest(X32, pm, used, CPU).bins.numpy(),
        _host_bins(X32, pm, used))


def test_chunk_rows_follow_the_width():
    """A chunk is a fixed budget of float32 bytes: 262,144 rows at 28
    features, fewer at larger widths; the default chunks of a ragged
    input cover every row once."""
    assert ingest.chunk_rows_for(28) == 262_144
    assert ingest.chunk_rows_for(200) * 200 * 4 <= ingest.CHUNK_BYTES
    assert ingest.chunk_rows_for(200) * 201 * 4 > ingest.CHUNK_BYTES
    X = _f32_matrix(3000, 4, seed=16, nan_cols=(1,))
    pm, rm = _both_mappers(X, max_bin=63)
    res = _check(X, pm, rm, chunk_rows=ingest.chunk_rows_for(4))
    assert res.chunk_rows == 3000 and res.chunks == 1
    old = ingest.CHUNK_BYTES
    ingest.CHUNK_BYTES = 4 * 4 * 1100          # 1,100 rows of 4 features
    try:
        res = ingest.device_ingest(X, pm, [0, 1, 2, 3], CPU)
    finally:
        ingest.CHUNK_BYTES = old
    assert res.chunk_rows == 1100 and res.chunks == 3
    np.testing.assert_array_equal(res.bins.numpy(),
                                  _host_bins(X, pm, [0, 1, 2, 3]))
    # the JAX package's chunk knob is no knob here: FATAL when set
    with pytest.raises(lgt.LightGBMError, match="tpu_ingest_chunk_rows"):
        lgt.Booster(params={"objective": "binary", "device_type": "cpu",
                            "tpu_ingest_chunk_rows": 4096, "verbosity": -1},
                    train_set=lgt.Dataset(X, label=(X[:, 0] > 0) * 1.0))


def test_tables_equal_reference():
    X = _f32_matrix(3000, 5, seed=11, nan_cols=(1,), cat_cols=(3,))
    pm, rm = _both_mappers(X, max_bin=63, categorical_features=[3])
    used = list(range(5))
    a = ingest.build_tables(pm, used)
    b = ref_ingest.build_tables(rm, used, np.uint8)
    for k in ("ub", "n_ub", "mt", "default_bin", "num_bin", "is_cat",
              "cat_sorted", "cat_perm"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)


# ---------------------------------------------------------------------------
# the Dataset and the engine
# ---------------------------------------------------------------------------
def _ds(X, y, mode, **extra):
    return lgt.Dataset(X, label=y, params={"tpu_ingest_device": mode,
                                           "device_type": "cpu", **extra})


def test_lazy_host_copy():
    X = _f32_matrix(4096, 5, seed=11)
    y = (X[:, 0] > 0).astype(np.float64)
    ds = _ds(X, y, "true").construct()
    assert ds.device_ingested() is not None
    assert ds._binned is None
    assert ds.binned_dtype() == np.uint8
    assert ds._binned is None             # the dtype probe keeps it so
    host = _ds(X, y, "false").construct()
    assert host.device_ingested() is None
    np.testing.assert_array_equal(ds.binned, host.binned)
    assert ds._binned is not None
    sub = ds.subset(np.arange(0, 4096, 3))
    np.testing.assert_array_equal(sub.binned, host.binned[::3])


def test_auto_stays_on_host_without_a_card():
    assert not torch.cuda.is_available()
    X = _f32_matrix(70_000, 3, seed=12)
    y = (X[:, 0] > 0).astype(np.float64)
    for p in ({}, {"device_type": "cpu"}, {"tpu_ingest_device": "auto"}):
        ds = lgt.Dataset(X, label=y, params=p).construct()
        assert ds.device_ingested() is None and ds._binned is not None


def test_true_with_cuda_and_no_card_is_fatal():
    assert not torch.cuda.is_available()
    X = _f32_matrix(1000, 3, seed=13)
    ds = lgt.Dataset(X, params={"tpu_ingest_device": "true"})
    with pytest.raises(lgt.LightGBMError, match="CUDA device"):
        ds.construct()


def test_stand_downs():
    X = _f32_matrix(1000, 3, seed=14)
    p = {"tpu_ingest_device": "on", "device_type": "cpu"}
    assert lgt.Dataset(X, params=p).construct().device_ingested() is not None
    import scipy.sparse as sp
    assert lgt.Dataset(sp.csr_matrix(X), params=p).construct() \
        .device_ingested() is None
    assert lgt.Dataset(X.tolist(), params=p).construct() \
        .device_ingested() is not None   # a list becomes a float64 array
    const = np.ones((1000, 3))
    assert lgt.Dataset(const, params=p).construct().device_ingested() is None


def test_device_data_adopts_ingested_bins():
    X = _f32_matrix(3000, 6, seed=12, nan_cols=(1,))
    y = (X[:, 0] > 0).astype(np.float64)
    dd_dev = DeviceData.from_dataset(_ds(X, y, "true").construct(), 512,
                                     CPU, transposed=True)
    dd_host = DeviceData.from_dataset(_ds(X, y, "false").construct(), 512,
                                      CPU, transposed=True)
    assert dd_dev.n_pad == dd_host.n_pad == 3072
    assert dd_dev.bins_t.dtype == torch.uint8
    assert torch.equal(dd_dev.bins, dd_host.bins)
    assert torch.equal(dd_dev.bins_t, dd_host.bins_t)
    # a second engine with other padding reads the same real rows
    ds = _ds(X, y, "true").construct()
    DeviceData.from_dataset(ds, 512, CPU, transposed=True)
    dd2 = DeviceData.from_dataset(ds, 256, CPU, transposed=True)
    assert dd2.n_pad == 3072 - 0 and torch.equal(dd2.bins, dd_host.bins)
    dd3 = DeviceData.from_dataset(ds, 2048, CPU, transposed=False)
    assert dd3.n_pad == 4096 and dd3.bins_t is None
    assert torch.equal(dd3.bins[:3000], dd_host.bins[:3000])
    assert not dd3.bins[3000:].any()
    np.testing.assert_array_equal(ds.binned, dd_host.bins[:3000].numpy())


def _body(text):
    """Model text outside the parameters block."""
    head, rest = text.split("\nparameters:", 1)
    return head + rest.split("end of parameters", 1)[1]


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.split("=", 1)[0] in ("split_feature", "threshold",
                                       "decision_type", "left_child",
                                       "right_child", "leaf_count",
                                       "num_leaves", "cat_threshold")]


def _bundleable(n, seed):
    """Dense columns and four mutually exclusive sparse ones."""
    rng = np.random.default_rng(seed)
    X = _f32_matrix(n, 4, seed=seed, nan_cols=(2,))
    sparse = np.zeros((n, 4))
    owner = rng.integers(0, 8, size=n)
    for j in range(4):
        rows = owner == j
        sparse[rows, j] = rng.integers(1, 9, size=rows.sum())
    return np.concatenate([X, sparse], axis=1)


@pytest.mark.parametrize("case", ["binary", "categorical", "bundleable",
                                  "multiclass"])
def test_training_from_ingested_bins(case):
    X = _f32_matrix(4000, 8, seed=13, nan_cols=(2,), cat_cols=(6,))
    rng = np.random.default_rng(13)
    y = (X[:, 0] + rng.normal(size=len(X)) * 0.3 > 0).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "tpu_leaf_batch": 8}
    cat = []
    if case == "categorical":
        cat = [6]
    elif case == "bundleable":
        X = _bundleable(4000, 14)
        y = (X[:, 0] + X[:, 5] > 1).astype(np.float64)
    elif case == "multiclass":
        y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
        params.update(objective="multiclass", num_class=3)
    texts, refs, engines = {}, {}, {}
    # on bundleable data the ingested runs skip the EFB probe (in both
    # packages alike), so the host-binned runs they are held to bundle
    # nothing either; the default host run does bundle
    nobundle = {"enable_bundle": False} if case == "bundleable" else {}
    for mode in ("false", "true"):
        extra = nobundle if mode == "false" else {}
        ds = lgt.Dataset(X, label=y, categorical_feature=cat)
        bst = lgt.train(dict(params, tpu_ingest_device=mode,
                             device_type="cpu", **extra), ds,
                        num_boost_round=4)
        texts[mode] = bst.model_to_string()
        engines[mode] = bst.engine
        assert (ds.device_ingested() is not None) == (mode == "true")
        r = lgb.train(dict(params, tpu_ingest_device=mode, **extra),
                      lgb.Dataset(X, label=y, categorical_feature=cat),
                      num_boost_round=4)
        refs[mode] = r.model_to_string()
    # the ingested dataset stays device-resident through training
    assert engines["true"].train_set._binned is None
    assert not engines["true"].has_bundles
    if case == "bundleable":
        bst = lgt.Booster(params=dict(params, device_type="cpu",
                                      tpu_ingest_device="false"),
                          train_set=lgt.Dataset(X, label=y))
        assert bst.engine.has_bundles
    assert _body(texts["true"]) == _body(texts["false"])
    assert _body(refs["true"]) == _body(refs["false"])
    # the reference's trees: the first iteration's split lines are
    # identical (gains and leaf values part in their last bits, as in
    # every parity test of the port, and later trees may part at ties)
    K = 3 if case == "multiclass" else 1

    def first_trees(text):
        return _split_lines(text.split("Tree=%d\n" % K)[0])
    assert first_trees(texts["true"]) == first_trees(refs["true"])


def test_host_upload_releases_the_ingest_arrays(capsys):
    """A host copy read before training lets EFB probe and bundle; the
    bundled matrix goes up from the host, and the device-resident ingest
    arrays are released instead of staying beside it. Without the host
    copy the probe is skipped, with a warning where EFB was asked for by
    name."""
    X = _bundleable(4000, 14)
    y = (X[:, 0] + X[:, 5] > 1).astype(np.float64)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": 1,
              "device_type": "cpu", "tpu_ingest_device": "true",
              "tpu_leaf_batch": 8}
    ds = _ds(X, y, "true").construct()
    assert ds.device_ingested() is not None
    host = ds.binned
    bst = lgt.Booster(params=params, train_set=ds)
    assert bst.engine.has_bundles
    assert ds.device_ingested() is None
    assert ds.binned is host
    bst.update()
    capsys.readouterr()
    for extra, level in (({}, "[Info]"),
                         ({"enable_bundle": True}, "[Warning]")):
        ds = lgt.Dataset(X, label=y)
        bst = lgt.Booster(params=dict(params, **extra), train_set=ds)
        assert not bst.engine.has_bundles
        assert ds.device_ingested() is not None and ds._binned is None
        err = capsys.readouterr()
        line = [ln for ln in (err.out + err.err).splitlines()
                if "EFB bundle probe skipped" in ln]
        assert len(line) == 1 and level in line[0]


def test_valid_set_follows_reference_and_booster_forwards():
    X = _f32_matrix(3000, 4, seed=15)
    y = (X[:, 0] > 0).astype(np.float64)
    ds = lgt.Dataset(X[:2000], label=y[:2000])
    vs = ds.create_valid(X[2000:], label=y[2000:])
    bst = lgt.Booster(params={"objective": "binary", "device_type": "cpu",
                              "tpu_ingest_device": "true",
                              "verbosity": -1}, train_set=ds)
    bst.add_valid(vs, "v")
    assert ds.params["tpu_ingest_device"] == "true"
    assert ds.params["device_type"] == "cpu"
    assert ds.device_ingested() is not None
    assert vs.device_ingested() is not None
    bst.update()
    assert bst.engine.valid_data[0].bins_t is None


def test_hbm_helpers():
    assert hbm.hbm_bytes_limit() is None
    assert hbm.binned_device_bytes(10, 3, 1, True) == 60
    assert hbm.binned_device_bytes(10, 3, 1, False) == 30
    assert 0 < hbm.STREAM_HBM_FRACTION < 1
