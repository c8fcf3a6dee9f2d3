"""Port parity: file input, binary datasets and ``Dataset.subset``.

CSV (with a header), TSV (with NaN), LibSVM, label / weight / group /
ignore columns by index and by ``name:``, and the ``.weight`` / ``.query``
sidecar files load as the JAX package's loader loads them, through the
port's native parser (``native/text_parser.cpp``). Training from a file
gives the model text of training from the same arrays, and the
reference's trees; ``save_binary`` round-trips; ``subset`` rebuilds query
boundaries; ``two_round=true`` is FATAL by name.
"""
import jax  # noqa: F401  (the JAX package runs on the CPU, see conftest)
import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import text_loader as ref_loader
from lightgbm_tpu_torch.io import text_loader
from test_torch_train import _reference_metrics_off  # noqa: F401

PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "tpu_leaf_batch": 4}
SPLIT_KEYS = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "feature_names", "feature_infos")


def _data(n=600, f=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X @ rng.normal(size=f) > 0).astype(float)
    return X, y


def _write(path, cols, names=None, delim=",", nan="NA"):
    """Columns written exactly (17 significant digits)."""
    with open(path, "w") as f:
        if names:
            f.write(delim.join(names) + "\n")
        for row in np.stack(cols, axis=1):
            f.write(delim.join(nan if np.isnan(v) else f"{v:.17g}"
                               for v in row) + "\n")


def _same_load(path, **kw):
    a = text_loader.load_text(path, **kw)
    b = ref_loader.load_text(path, **kw)
    np.testing.assert_array_equal(a.X, b.X)
    for k in ("label", "weight", "group"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert a.feature_names == b.feature_names
    assert text_loader.sniff_format(path) == ref_loader.sniff_format(path)
    return a


def _body(text):
    head, rest = text.split("\nparameters:", 1)
    return head + rest.split("end of parameters", 1)[1]


def _first_tree_lines(text):
    return [ln for ln in text.split("Tree=1\n")[0].splitlines()
            if ln.split("=", 1)[0] in SPLIT_KEYS]


def test_csv_with_header(tmp_path):
    X, y = _data()
    path = str(tmp_path / "train.csv")
    _write(path, [y, *X.T], ["target"] + [f"f{i}" for i in range(5)])
    got = _same_load(path)
    assert text_loader.sniff_format(path) == ("csv", ",", True)
    np.testing.assert_array_equal(got.X, X)
    np.testing.assert_array_equal(got.label, y)
    assert got.feature_names == [f"f{i}" for i in range(5)]


def test_tsv_without_header_with_nan(tmp_path):
    X, y = _data(n=100)
    X[3, 2] = np.nan
    X[7, 0] = np.nan
    path = str(tmp_path / "train.tsv")
    _write(path, [y, *X.T], delim="\t")
    got = _same_load(path)
    assert text_loader.sniff_format(path) == ("csv", "\t", False)
    assert np.isnan(got.X[3, 2]) and np.isnan(got.X[7, 0])
    with open(path) as f:
        lines = f.read().splitlines()
    lines[5] = lines[5].replace("NA", "?")
    lines.insert(3, "# a comment line")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    _same_load(path)


def test_libsvm(tmp_path):
    rng = np.random.default_rng(2)
    n, F = 300, 8
    X = np.zeros((n, F))
    y = rng.integers(0, 2, n).astype(float)
    for i in range(n):
        for j in rng.choice(F, size=3, replace=False):
            X[i, j] = round(float(rng.normal()), 6)
    path = str(tmp_path / "train.svm")
    with open(path, "w") as f:
        for i in range(n):
            nz = np.flatnonzero(X[i])
            f.write(f"{y[i]:g} " + " ".join(
                f"{j}:{X[i, j]:.6g}" for j in nz) + "\n")
    got = _same_load(path)
    assert text_loader.sniff_format(path)[0] == "libsvm"
    np.testing.assert_array_equal(got.label, y)
    np.testing.assert_allclose(got.X, X[:, :got.X.shape[1]], rtol=1e-5)


@pytest.mark.parametrize("spec", ["index", "name"])
def test_label_weight_group_ignore_columns(tmp_path, spec):
    X, y = _data(n=200, f=4)
    qid = np.repeat(np.arange(20), 10)[::-1].copy()   # ids not ascending
    w = np.linspace(0.5, 1.5, 200)
    names = ["f0", "w", "f1", "qid", "target", "f2", "junk", "f3"]
    junk = np.full(200, 7.0)
    path = str(tmp_path / "rank.csv")
    _write(path, [X[:, 0], w, X[:, 1], qid, y, X[:, 2], junk, X[:, 3]],
           names)
    if spec == "index":
        kw = dict(label_column="4", weight_column="1", group_column="3",
                  ignore_column="6")
    else:
        kw = dict(label_column="name:target", weight_column="name:w",
                  group_column="name:qid", ignore_column="name:junk")
    got = _same_load(path, **kw)
    np.testing.assert_array_equal(got.X, X)
    np.testing.assert_array_equal(got.label, y)
    np.testing.assert_array_equal(got.weight, w)
    np.testing.assert_array_equal(got.group, np.full(20, 10))
    assert got.feature_names == ["f0", "f1", "f2", "f3"]
    # the same through the Dataset's parameters
    ds = lgt.Dataset(path, params={"label": kw["label_column"],
                                   "weight": kw["weight_column"],
                                   "query": kw["group_column"],
                                   "ignore_feature": kw["ignore_column"]})
    ds.construct()
    np.testing.assert_array_equal(ds.get_group(), np.full(20, 10))
    np.testing.assert_array_equal(ds.metadata.weight, w)
    assert ds.feature_names == ["f0", "f1", "f2", "f3"]


def test_sidecar_files(tmp_path):
    X, y = _data(n=200)
    path = str(tmp_path / "rank.tsv")
    _write(path, [y, *X.T], delim="\t")
    np.savetxt(path + ".weight", np.linspace(0.5, 1.5, 200))
    np.savetxt(path + ".query", np.full(10, 20), fmt="%d")
    got = _same_load(path)
    assert len(got.weight) == 200 and got.group.sum() == 200
    ds = lgt.Dataset(path).construct()
    np.testing.assert_array_equal(ds.get_group(), np.full(10, 20))
    # metadata the caller passes wins over the sidecars
    ds = lgt.Dataset(path, weight=np.ones(200)).construct()
    np.testing.assert_array_equal(ds.metadata.weight, np.ones(200))


@pytest.mark.parametrize("fmt", ["csv", "tsv", "svm"])
def test_train_from_file_equals_arrays_and_reference(tmp_path, fmt):
    X, y = _data(n=1500, f=6, seed=3)
    path = str(tmp_path / f"train.{fmt}")
    if fmt == "svm":
        X = np.where(np.abs(X) < 0.5, 0.0, np.round(X, 4))
        with open(path, "w") as f:
            for i in range(len(X)):
                nz = np.flatnonzero(X[i])
                f.write(f"{y[i]:g} " + " ".join(
                    f"{j}:{X[i, j]:.17g}" for j in nz) + "\n")
        names = None
    else:
        names = ["y"] + [f"c{i}" for i in range(6)] if fmt == "csv" \
            else None
        _write(path, [y, *X.T], names, delim="," if fmt == "csv" else "\t")
    params = dict(PARAMS, device_type="cpu")
    from_file = lgt.train(params, lgt.Dataset(path), num_boost_round=5)
    feat = ({"feature_name": names[1:]} if names else {})
    from_arrays = lgt.train(params, lgt.Dataset(X, label=y, **feat),
                            num_boost_round=5)
    text = from_file.model_to_string()
    assert _body(text) == _body(from_arrays.model_to_string())
    ref = lgb.train(dict(PARAMS), lgb.Dataset(path), num_boost_round=5)
    assert _first_tree_lines(text) == _first_tree_lines(
        ref.model_to_string())
    np.testing.assert_allclose(from_file.predict(X), ref.predict(X),
                               rtol=0, atol=1e-5)


def test_binary_round_trip(tmp_path):
    X, y = _data(n=800)
    X[::5, 1] = np.nan
    X[:, 4] = np.abs(np.round(X[:, 4] * 3))
    ds = lgt.Dataset(X, label=y, weight=np.linspace(1, 2, 800),
                     categorical_feature=[4],
                     params={"max_bin": 63}).construct()
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    back = lgt.Dataset(path)
    assert back.num_data == 800 and back.categorical_idx == [4]
    np.testing.assert_array_equal(back.binned, ds.binned)
    np.testing.assert_array_equal(back.metadata.weight, ds.metadata.weight)
    assert back.params["max_bin"] == 63
    params = dict(PARAMS, device_type="cpu", max_bin=63)
    a = lgt.train(params, lgt.Dataset(X, label=y,
                                      weight=np.linspace(1, 2, 800),
                                      categorical_feature=[4]),
                  num_boost_round=4)
    b = lgt.train(params, back, num_boost_round=4)
    assert _body(a.model_to_string()) == _body(b.model_to_string())
    # a label passed with the file overrides the stored one
    flipped = lgt.Dataset(path, label=1.0 - y)
    np.testing.assert_array_equal(flipped.metadata.label, 1.0 - y)


def test_binary_round_trip_of_an_ingested_dataset(tmp_path):
    X, y = _data(n=500)
    ds = lgt.Dataset(X, label=y, params={"tpu_ingest_device": "true",
                                         "device_type": "cpu"}).construct()
    assert ds.device_ingested() is not None and ds._binned is None
    path = str(tmp_path / "ingested.bin")
    ds.save_binary(path)
    back = lgt.Dataset(path)
    assert back.device_ingested() is None
    np.testing.assert_array_equal(back.binned,
                                  lgt.Dataset(X, label=y).construct().binned)


def test_subset_with_groups():
    X, y = _data(n=300, f=4, seed=5)
    counts = np.array([30, 50, 20, 100, 40, 60])
    ds = lgt.Dataset(X, label=y, group=counts,
                     init_score=np.arange(300, dtype=float)).construct()
    # n * K init scores are read row by row
    multi = lgt.Dataset(X, label=y, init_score=np.arange(900, dtype=float))
    multi.construct()
    np.testing.assert_array_equal(
        multi.subset([2, 5]).metadata.init_score, [6, 7, 8, 15, 16, 17])
    ds.set_position(np.arange(300) % 7)
    keep = np.concatenate([np.arange(30, 80), np.arange(200, 300)])
    sub = ds.subset(keep)
    np.testing.assert_array_equal(sub.get_group(), [50, 40, 60])
    np.testing.assert_array_equal(sub.binned, ds.binned[keep])
    np.testing.assert_array_equal(sub.metadata.label, y[keep])
    np.testing.assert_array_equal(sub.metadata.init_score, keep)
    np.testing.assert_array_equal(sub.metadata.position, keep % 7)
    assert sub.bin_mappers is ds.bin_mappers and sub.num_data == 150
    ref = lgb.Dataset(X, label=y, group=counts).construct().subset(keep)
    np.testing.assert_array_equal(sub.get_group(), ref.get_group())
    bst = lgt.train({"objective": "lambdarank", "num_leaves": 7,
                     "verbosity": -1, "device_type": "cpu"}, sub,
                    num_boost_round=2)
    assert bst.current_iteration() == 2


def test_two_round_is_fatal_by_name(tmp_path):
    X, y = _data(n=50)
    path = str(tmp_path / "train.csv")
    _write(path, [y, *X.T])
    for p in ({"two_round": True}, {"two_round_loading": "true"}):
        with pytest.raises(lgt.LightGBMError, match="two_round"):
            lgt.Dataset(path, params=p)
