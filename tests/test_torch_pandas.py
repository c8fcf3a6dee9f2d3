"""Port parity: pandas DataFrames with category columns.

A frame's category-dtype columns are categorical features, binned from
their codes; the category lists are the model text's
``pandas_categorical``, and predict codes a frame by the training lists
(so categories in another order, or unseen ones, map as in training).
For int and for str categories the port's ``categorical_idx``,
``pandas_categorical``, bins, model text (of the reference's trees,
carried across by ``forest_from_jax``) and predictions must equal the
JAX package's, for the engine and for a model loaded from text.
"""
import jax  # noqa: F401  (the JAX package runs on the CPU, see conftest)
import numpy as np
import pandas as pd
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import forest_from_jax
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
          "min_data_per_group": 20, "tpu_leaf_batch": 4, "verbosity": -1}
ROUNDS = 3
CATS = {"int": [10, 20, 30, 40], "str": ["x", "y", "z", "w"]}
SPLIT_KEYS = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "cat_boundaries", "cat_threshold")


def _frame(kind, n=2000, seed=0, order=None):
    rng = np.random.default_rng(seed)
    cats = CATS[kind]
    c = rng.integers(0, len(cats), size=n)
    d = rng.integers(0, 3, size=n)
    a = rng.normal(size=n)
    y = ((c == 1) | (c == 3) & (a > 0) | (d == 2) & (a > 1)).astype(float)
    vals = pd.Categorical([cats[i] for i in c],
                          categories=order if order is not None else cats)
    df = pd.DataFrame({"a": a, "c": vals, "b": rng.normal(size=n),
                       "d": pd.Categorical(d)})
    df.loc[rng.random(n) < 0.05, "c"] = np.nan
    return df, y


_RUNS = {}


def trained(kind):
    if kind not in _RUNS:
        df, y = _frame(kind)
        ds_r = lgb.Dataset(df, label=y)
        ref = lgb.Booster(params=dict(PARAMS), train_set=ds_r)
        fetched = []
        fetch = ref.engine._fetch_tree_arrays
        ref.engine._fetch_tree_arrays = \
            lambda st: fetched.append(fetch(st)) or fetched[-1]
        for _ in range(ROUNDS):
            ref.update()
        ds_p = lgt.Dataset(df, label=y)
        port = lgt.train(dict(PARAMS, device_type="cpu"), ds_p,
                         num_boost_round=ROUNDS,
                         noise=JaxReplayNoise(Config({}).objective_seed))
        _RUNS[kind] = (ref, port, ds_r, ds_p, fetched)
    return _RUNS[kind]


def _split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.split("=", 1)[0] in SPLIT_KEYS]


@pytest.mark.parametrize("kind", list(CATS))
def test_dataset_fields_and_bins_equal_reference(kind):
    _, _, ds_r, ds_p, _ = trained(kind)
    assert ds_p.categorical_idx == ds_r.categorical_idx == [1, 3]
    assert ds_p.pandas_categorical == ds_r.pandas_categorical
    assert ds_p.pandas_categorical == [CATS[kind], [0, 1, 2]]
    assert ds_p.feature_names == ds_r.feature_names == ["a", "c", "b", "d"]
    assert ds_p.bin_mappers[1].bin_type == "categorical"
    np.testing.assert_array_equal(ds_p.binned, np.asarray(ds_r.binned))


@pytest.mark.parametrize("kind", list(CATS))
def test_trees_and_predictions_equal_reference(kind):
    ref, port, _, _, _ = trained(kind)
    text_p, text_r = port.model_to_string(), ref.model_to_string()
    assert _split_lines(text_p) == _split_lines(text_r)
    assert "cat_threshold=" in text_p
    df, _ = _frame(kind, n=500, seed=1)
    np.testing.assert_allclose(port.predict(df), ref.predict(df), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", list(CATS))
def test_model_text_equals_reference_on_the_same_trees(kind):
    ref, port, _, _, fetched = trained(kind)
    eng = port.engine
    saved = (eng.models, eng.init_scores, eng._stack_cache)
    try:
        eng.models = forest_from_jax(fetched, PARAMS["learning_rate"],
                                     eng.train_set.bin_mappers,
                                     eng.train_set.used_features)
        eng.init_scores = np.asarray(ref.engine.init_scores, np.float64)
        eng._stack_cache = None
        text = port.model_to_string()
        df, _ = _frame(kind, n=500, seed=2)
        np.testing.assert_allclose(eng.predict(df), ref.predict(df),
                                   rtol=0, atol=1e-6)
    finally:
        eng.models, eng.init_scores, eng._stack_cache = saved
    want = ref.model_to_string()
    assert text.split("\nparameters:")[0] == want.split("\nparameters:")[0]
    tail = text.split("end of parameters")[1]
    assert tail == want.split("end of parameters")[1]
    assert "pandas_categorical:[" in tail


@pytest.mark.parametrize("kind", list(CATS))
@pytest.mark.parametrize("frame", ["reordered", "unseen"])
def test_predict_codes_by_training_lists(kind, frame):
    """Categories in another order, or values training never saw (NaN's
    bin), predict as the reference does: on the engine, on a model loaded
    from the port's text and on one loaded from the reference's."""
    ref, port, _, _, _ = trained(kind)
    cats = CATS[kind]
    if frame == "reordered":
        df, _ = _frame(kind, n=600, seed=3, order=cats[::-1])
        plain, _ = _frame(kind, n=600, seed=3)
        np.testing.assert_allclose(port.predict(df), port.predict(plain),
                                   rtol=0, atol=0)
    else:
        df, _ = _frame(kind, n=600, seed=4)
        new = 99 if kind == "int" else "v"
        df["c"] = df["c"].cat.add_categories([new])
        df.loc[::3, "c"] = new
    want = ref.predict(df)
    np.testing.assert_allclose(port.predict(df), want, rtol=0, atol=1e-5)
    loaded = lgt.Booster(model_str=port.model_to_string())
    np.testing.assert_allclose(loaded.predict(df), port.predict(df),
                               rtol=0, atol=1e-6)
    from_ref = lgt.Booster(model_str=ref.model_to_string())
    np.testing.assert_allclose(from_ref.predict(df), want, rtol=0, atol=1e-6)


def test_valid_set_inherits_training_lists():
    df, y = _frame("str")
    ds = lgt.Dataset(df, label=y)
    other, yv = _frame("str", n=400, seed=5, order=["w", "z", "y", "x"])
    vs = ds.create_valid(other, label=yv)
    bst = lgt.Booster(params=dict(PARAMS, device_type="cpu"), train_set=ds)
    bst.add_valid(vs, "v")
    assert vs.pandas_categorical == ds.pandas_categorical
    same, _ = _frame("str", n=400, seed=5)
    np.testing.assert_array_equal(
        vs.binned, lgt.Dataset(same, reference=ds).construct().binned)


def test_mismatched_category_columns_are_fatal():
    _, port, _, _, _ = trained("int")
    df, _ = _frame("int", n=50)
    with pytest.raises(lgt.LightGBMError, match="pandas_categorical"):
        port.predict(df.drop(columns=["d"]).assign(d=1.0))
    bad = pd.DataFrame({"t": pd.Categorical(
        [pd.Timestamp("2020-01-01"), pd.Timestamp("2021-01-01")] * 10)})
    with pytest.raises(lgt.LightGBMError, match="JSON"):
        lgt.Dataset(bad, label=np.zeros(20)).construct()


def test_frame_without_categories_and_explicit_names():
    df, y = _frame("int")
    plain = df.assign(c=df["c"].cat.codes.astype(float),
                      d=df["d"].cat.codes.astype(float))
    ds = lgt.Dataset(plain, label=y, categorical_feature=["c", "d"])
    ds.construct()
    assert ds.categorical_idx == [1, 3] and ds.pandas_categorical is None
