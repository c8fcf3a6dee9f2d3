"""Port parity: categorical features, from the split search to the model text.

Both packages get the same inputs:

- the split search (``find_best_split`` with ``is_cat``) on seeded
  histograms with one-hot and sorted categorical features, tied ratios,
  ``max_cat_threshold`` caps, ``min_data_per_group`` and empty bins,
  against the reference's scan over all features masked and over the
  categorical positions only: gain, feature, ``is_cat`` and bitset
  bit-equal (float and integer histograms alike: the sorts are stable and
  the sorted prefix sums add in XLA's order);
- ``grow_tree`` on the same bins and integer gradient levels with a
  power-of-two scale (every sum exact): identical tree arrays, bitsets
  included, and leaf ids, on the masked path, the compacted GOSS buffer
  and the row partition;
- end to end on data shaped like ``bench.py``'s categorical guard (10
  numeric columns with 10% NaN in five, a 12-way and a 40-way categorical
  column, here with a 3-way one for the one-hot mode and 10% NaN in the
  categorical columns), with the reference's draws replayed: the masked
  path, GOSS with compaction and the row partition, for binary,
  regression and 3-class multiclass: every tree puts the same training
  rows in each leaf and splits on the same features, categorical splits
  occur in every model and as often in both, and the holdout predictions
  differ by at most 1e-5.

The split lines themselves can differ, and the end-to-end check allows
it. The sorted scan offers a left set twice at equal gain in exact
arithmetic: as a prefix of the ascending order, and its complement
among the valid bins as a prefix of the descending order, with the
children swapped. That happens whenever bin 0 (NaN and unseen
categories) is empty in the leaf, as it is below any categorical split
on the same feature. Both packages take the first of equal gains
(``test_complement_tie_takes_the_ascending_prefix``), but the two gains
are sums in different orders, so on floats which one is larger follows
the histograms' last bits, and those differ between the packages by
ULPs (the sigmoid and softmax, the reference's FMA contraction of leaf
values, ROADMAP Queue 3). Where they part there, both send the same rows
to each side, the leaves are numbered in another order, and the trees
predict alike.

The model text of the reference's trees carried across by
``forest_from_jax`` equals the reference's, and NaN and unseen
categories route right on raw features and on bins as in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.learner.serial import GrowConfig as JaxGrowConfig
from lightgbm_tpu.learner.serial import grow_tree as jax_grow_tree
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import forest_from_jax
from lightgbm_tpu_torch.learner.serial import GrowConfig, grow_tree
from lightgbm_tpu_torch.ops import split as ts
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

POW2_SCALE = np.array([2.0 ** -6, 2.0 ** -5, 1.0], np.float32)
CAT_COLS = [10, 11, 12]
ROUNDS = 3
TOL = 1e-5
BASE = {"num_leaves": 15, "learning_rate": 0.5, "use_quantized_grad": True,
        "tpu_leaf_batch": 4, "min_data_per_group": 50, "verbosity": -1}
# path -> (training rows, params); GOSS starts at iteration 1/lr = 2
PATHS = {
    "masked": (3000, {"tpu_hist_partition": "false"}),
    "partition": (3000, {"tpu_hist_partition": "true"}),
    "goss": (16_000, {"data_sample_strategy": "goss", "top_rate": 0.1,
                      "other_rate": 0.05, "tpu_goss_compact": True}),
}
OBJECTIVES = {"binary": {"objective": "binary"},
              "regression": {"objective": "regression"},
              "multiclass": {"objective": "multiclass", "num_class": 3}}
SPLIT_KEYS = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "num_leaves")


# ---- (a) the split search ---------------------------------------------------
def _cat_hists(C, F, B, seed, integer):
    """``C`` leaves' histograms over F features, half of them categorical
    (the first three with 2-4 categories: the one-hot mode), with empty
    bins, and in integer mode many equal ratios."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(3, B + 1, size=F).astype(np.int32)
    nb[:3] = (3, 4, 5)
    is_cat = rng.random(F) < 0.5
    is_cat[:3] = True
    has_nan = (rng.random(F) < 0.3) & ~is_cat
    if integer:
        g = rng.integers(-20, 21, size=(C, F, B)).astype(np.float64)
        h = rng.integers(0, 30, size=(C, F, B)).astype(np.float64)
    else:
        g = rng.normal(size=(C, F, B)) * 3
        h = rng.uniform(0.01, 2.0, size=(C, F, B))
    c = rng.integers(0, 400, size=(C, F, B)).astype(np.float64)
    c[rng.random(c.shape) < 0.1] = 0                       # empty bins
    g, h = np.where(c > 0, g, 0), np.where(c > 0, h, 0)
    hist = np.stack([g, h, c], -1).astype(np.float32)
    hist *= (np.arange(B)[None, :] < nb[:, None])[None, :, :, None]
    sums = hist[:, 0].sum(axis=1)
    allowed = rng.random((C, F)) < 0.9
    return hist, sums, nb, has_nan, is_cat, allowed


SPLIT_CFGS = {
    "defaults": dict(min_data_in_leaf=5, min_data_per_group=10),
    "capped": dict(max_cat_threshold=4, min_data_per_group=50,
                   cat_smooth=1.0, cat_l2=1.0, max_cat_to_onehot=8),
    "l1": dict(lambda_l1=0.5, lambda_l2=1.0, min_data_per_group=1,
               min_data_in_leaf=1, min_gain_to_split=0.5),
}


# ref_positions: the reference scans the categorical positions only (its
# cat_positions), else every feature masked; the port scans the positions
@pytest.mark.parametrize("integer,ref_positions", [(False, False),
                                                   (True, True)])
@pytest.mark.parametrize("cfg", list(SPLIT_CFGS))
def test_categorical_split_search_bit_equal(cfg, integer, ref_positions):
    B = 256 if integer else 64
    hist, sums, nb, hn, ic, allowed = _cat_hists(24, 12, B, B + integer,
                                                 integer)
    pos = np.nonzero(ic)[0]
    jcfg = js.SplitConfig(
        has_categorical=True,
        cat_positions=tuple(pos.tolist()) if ref_positions else (),
        **SPLIT_CFGS[cfg])
    tcfg = ts.SplitConfig(has_categorical=True, **SPLIT_CFGS[cfg])
    ref = jax.jit(jax.vmap(lambda h, s, a: js.find_best_split(
        h, s, jnp.asarray(nb), jnp.asarray(hn), a, jcfg,
        is_cat=jnp.asarray(ic))))(jnp.asarray(hist), jnp.asarray(sums),
                                  jnp.asarray(allowed))
    out = ts.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(sums), torch.from_numpy(nb),
        torch.from_numpy(hn), torch.from_numpy(allowed), tcfg,
        is_cat=torch.from_numpy(ic), cat_idx=torch.from_numpy(pos))
    assert set(out) == set(ref)
    for k, v in out.items():
        got, want = v.numpy(), np.asarray(ref[k])
        if k == "cat_bitset":         # int64 words of uint32 bit patterns
            assert got.min() >= 0 and got.max() < 2 ** 32
            got = got.astype(np.uint32)
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    won = np.asarray(ref["is_cat"])
    assert 0 < won.sum() < len(won)    # both kinds of split win somewhere


def test_complement_tie_takes_the_ascending_prefix():
    """Bin 0 empty: the ascending prefix {1, 2} and the descending prefix
    {3, 4, 5} split the leaf alike with the children swapped, at exactly
    equal gains on integer sums. Both packages take the ascending one."""
    hist = np.zeros((1, 1, 8, 3), np.float32)
    hist[0, 0, 1:6] = [(-8, 4, 40), (-6, 4, 40), (3, 4, 40), (5, 4, 40),
                       (6, 4, 40)]
    sums = hist[:, 0].sum(axis=1)
    nb, hn, ic = np.array([6], np.int32), np.zeros(1, bool), np.ones(1, bool)
    kw = dict(min_data_per_group=10, min_data_in_leaf=10, cat_smooth=0.0)
    ref = jax.jit(lambda h, s: js.find_best_split(
        h, s, jnp.asarray(nb), jnp.asarray(hn), jnp.asarray(ic),
        js.SplitConfig(has_categorical=True, **kw),
        is_cat=jnp.asarray(ic)))(jnp.asarray(hist[0]), jnp.asarray(sums[0]))
    out = ts.find_best_split(torch.from_numpy(hist), torch.from_numpy(sums),
                             torch.from_numpy(nb), torch.from_numpy(hn),
                             torch.from_numpy(ic),
                             ts.SplitConfig(has_categorical=True, **kw),
                             is_cat=torch.from_numpy(ic),
                             cat_idx=torch.zeros(1, dtype=torch.int64))
    assert int(np.asarray(ref["cat_bitset"])[0]) == 0b110
    assert int(out["cat_bitset"][0, 0]) == 0b110
    np.testing.assert_array_equal(out["gain"].numpy()[0],
                                  np.asarray(ref["gain"]))


def test_pack_bitset_matches_reference():
    rng = np.random.default_rng(5)
    for B in (8, 40, 64, 256):
        inset = rng.random((3, B)) < 0.5
        want = np.stack([np.asarray(js._pack_bitset(jnp.asarray(r),
                                                    (B + 31) // 32))
                         for r in inset])
        got = ts._pack_bitset(torch.from_numpy(inset)).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)


# ---- (b) grow_tree ----------------------------------------------------------
def _grow_data(n=8192, F=12, B=64, seed=0):
    """Bins with four categorical features (4, 40 and two random category
    counts) that carry the integer gradient levels."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(8, B + 1, size=F).astype(np.int32)
    is_cat = np.zeros(F, bool)
    is_cat[[1, 4, 7, 9]] = True
    nb[1], nb[4] = 4, 40
    has_nan = (rng.random(F) < 0.3) & ~is_cat
    bins = (rng.random((n, F)) * nb[None, :]).astype(np.uint8)
    eff = rng.normal(size=64)
    g = np.clip(np.round(rng.normal(size=n) + 2 * eff[bins[:, 4]]
                         + 1.5 * eff[bins[:, 1] + 10]), -8, 8)
    h = rng.integers(0, 4, size=n)
    m = (rng.random(n) < 0.9).astype(np.float32)
    vals = np.stack([g * m, h * m, m], 1).astype(np.float32)
    return bins, vals, nb, has_nan, is_cat


@pytest.mark.parametrize("leaf_batch,compact,partition,ref_positions", [
    (1, False, False, True), (8, True, False, False), (8, True, True, True)])
def test_grow_tree_categorical_bit_equal(leaf_batch, compact, partition,
                                         ref_positions):
    bins, vals, nb, hn, ic = _grow_data(seed=leaf_batch + compact)
    F = bins.shape[1]
    pos = tuple(int(i) for i in np.nonzero(ic)[0]) if ref_positions else ()
    kw = dict(num_leaves=31, num_bins=64, leaf_batch=leaf_batch,
              hist_compact=compact, partition=partition, min_data_in_leaf=5,
              has_categorical=True, min_data_per_group=20, cat_smooth=5.0,
              max_cat_threshold=8)
    j = dict(chan_scale=jnp.asarray(POW2_SCALE))
    t = dict(chan_scale=torch.from_numpy(POW2_SCALE))
    hv = vals
    if compact:
        idx = np.sort(np.random.default_rng(7).choice(len(bins), 4096,
                                                      replace=False))
        hv = vals[idx]
        j["compact"] = (jnp.asarray(bins[idx]), None, jnp.asarray(hv))
        t["compact_bins_t"] = torch.from_numpy(bins[idx].T.copy())
    allowed = np.ones(F, bool)
    jt, jl = jax_grow_tree(jnp.asarray(bins), jnp.asarray(hv),
                           jnp.asarray(nb), jnp.asarray(hn),
                           jnp.asarray(allowed),
                           JaxGrowConfig(rows_per_block=1024,
                                         cat_positions=pos, **kw),
                           is_cat=jnp.asarray(ic), **j)
    tt, tl = grow_tree(torch.from_numpy(bins.T.copy()), torch.from_numpy(hv),
                       torch.from_numpy(nb), torch.from_numpy(hn),
                       torch.from_numpy(allowed),
                       GrowConfig(int_hist=True, **kw),
                       is_cat=torch.from_numpy(ic), **t)
    assert set(tt) == set(jt)
    assert int(tt["num_leaves"]) == 31
    assert int(np.asarray(jt["is_cat"]).sum()) >= 3
    for k, v in tt.items():
        got = np.asarray(v.cpu() if torch.is_tensor(v) else v)
        if k == "cat_bitset":
            got = got.astype(np.uint32)
        want = np.asarray(jt[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_numerical_tree_has_no_categorical_arrays():
    """Without categorical features grow_tree returns the numerical
    path's arrays only (so its model text stays as it was)."""
    bins, vals, nb, hn, _ = _grow_data(n=2048)
    tt, _ = grow_tree(torch.from_numpy(bins.T.copy()), torch.from_numpy(vals),
                      torch.from_numpy(nb), torch.from_numpy(hn),
                      torch.ones(bins.shape[1], dtype=torch.bool),
                      GrowConfig(num_leaves=7, num_bins=64, int_hist=True),
                      chan_scale=torch.from_numpy(POW2_SCALE))
    assert "is_cat" not in tt and "cat_bitset" not in tt


# ---- (c) end to end ---------------------------------------------------------
def guard_data(n, objective, seed=7):
    """``bench.py::synth_guard`` (n rows: 10 numeric columns, pairwise
    interactions, 10% NaN with signal in five; a 12-way and a 40-way
    categorical column) plus a 3-way categorical column, and 10% NaN in
    the three categorical columns; the label suits ``objective``."""
    rng = np.random.default_rng(seed)
    Xn = rng.normal(size=(n, 10))
    c1 = rng.integers(0, 12, size=n)
    c2 = rng.integers(0, 40, size=n)
    c3 = rng.integers(0, 3, size=n)
    logit = (1.0 * Xn[:, 0] * Xn[:, 1] + 0.9 * Xn[:, 2] * Xn[:, 3]
             - 0.7 * Xn[:, 4] * np.abs(Xn[:, 5])
             + rng.normal(size=12)[c1] * 1.2 + rng.normal(size=40)[c2] * 0.8
             + np.array([0.5, -0.6, 0.2])[c3])
    for j in range(5):
        miss = rng.uniform(size=n) < 0.10
        logit = logit + np.where(miss, 0.6, 0.0)
        Xn[miss, j] = np.nan
    noisy = logit + rng.normal(size=n)
    if objective == "binary":
        y = (noisy > 0).astype(np.float64)
    elif objective == "multiclass":
        y = np.digitize(noisy, np.quantile(noisy, [1 / 3, 2 / 3])) \
            .astype(np.float64)
    else:
        y = noisy
    X = np.column_stack([Xn, c1, c2, c3]).astype(np.float64)
    for j in CAT_COLS:
        X[rng.uniform(size=n) < 0.10, j] = np.nan
    return X, y


_RUNS = {}


def trained(objective, path):
    """Both packages trained on the same guard-shaped data (cached for the
    module): (reference, port, holdout X, the reference's tree arrays)."""
    key = (objective, path)
    if key not in _RUNS:
        n, extra = PATHS[path]
        X, y = guard_data(n + 1000, objective)
        params = dict(BASE, **extra, **OBJECTIVES[objective])
        ref = lgb.Booster(params=dict(params), train_set=lgb.Dataset(
            X[:n], label=y[:n], categorical_feature=CAT_COLS))
        eng = ref.engine
        assert eng.has_categorical
        assert eng.hist_partition == (path == "partition")
        fetched = []
        fetch = eng._fetch_tree_arrays
        eng._fetch_tree_arrays = lambda st: fetched.append(fetch(st)) or \
            fetched[-1]
        for _ in range(ROUNDS):
            ref.update()
        port = lgt.train(dict(params, device_type="cpu"),
                         lgt.Dataset(X[:n], label=y[:n],
                                     categorical_feature=CAT_COLS),
                         num_boost_round=ROUNDS,
                         noise=JaxReplayNoise(Config({}).objective_seed))
        pe = port.engine
        assert pe.has_categorical and pe.grow_cfg.int_hist
        assert pe.hist_partition == (path == "partition")
        assert pe.use_goss_compact == (path == "goss")
        _RUNS[key] = (ref, port, X[n:], X[:n], fetched)
    return _RUNS[key]


def split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.split("=", 1)[0] in SPLIT_KEYS]


def categorical_splits(lines):
    return sum(int(v) & 1 for ln in lines if ln.startswith("decision_type=")
               for v in ln.split("=", 1)[1].split())


def same_leaf_rows(leaf_p, leaf_r):
    """Every tree puts the same rows together in its leaves: the map from
    the port's leaf to the reference's is one to one ([n, T] indices)."""
    for t in range(leaf_p.shape[1]):
        pairs = set(zip(leaf_p[:, t].tolist(), leaf_r[:, t].tolist()))
        if not (len(pairs) == len(set(leaf_p[:, t]))
                == len(set(leaf_r[:, t]))):
            return False
    return True


def tree_signature(text):
    """Per tree: the sorted split features and the categorical count,
    which do not depend on the order the leaves are numbered in."""
    out = []
    for t in text.split("\nTree=")[1:]:
        kv = dict(ln.split("=", 1) for ln in t.splitlines() if "=" in ln)
        out.append((sorted(kv.get("split_feature", "").split()),
                    categorical_splits(["decision_type="
                                        + kv.get("decision_type", "")])))
    return out


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_port_matches_reference(objective, path):
    ref, port, Xv, Xt, _ = trained(objective, path)
    text_p, text_r = port.model_to_string(), ref.model_to_string()
    lines = split_lines(text_p)
    K = port.engine.num_class
    assert len(lines) == len(SPLIT_KEYS) * ROUNDS * K
    assert categorical_splits(lines) > 0
    assert tree_signature(text_p) == tree_signature(text_r)
    assert same_leaf_rows(port.predict(Xt, pred_leaf=True),
                          ref.predict(Xt, pred_leaf=True))
    dp = np.abs(port.predict(Xv) - ref.predict(Xv)).max()
    assert dp <= TOL, dp


# ---- (d) model text, raw predict, NaN and unseen categories -----------------
def test_model_text_equals_reference_on_the_same_trees():
    ref, port, Xv, _, fetched = trained("binary", "masked")
    eng = port.engine
    saved = (eng.models, eng.init_scores, eng._stack_cache)
    try:
        eng.models = forest_from_jax(fetched, float(BASE["learning_rate"]),
                                     eng.train_set.bin_mappers,
                                     eng.train_set.used_features)
        eng.init_scores = np.asarray(ref.engine.init_scores, np.float64)
        eng._stack_cache = None
        assert any(t.is_categorical is not None for t in eng.models)
        text = port.model_to_string()
        np.testing.assert_allclose(eng.predict(Xv), ref.predict(Xv),
                                   rtol=0, atol=1e-6)
    finally:
        eng.models, eng.init_scores, eng._stack_cache = saved
    want = ref.model_to_string()
    # trees, feature_infos (categories of the categorical columns) and
    # feature importances; the parameters block lists each package's own
    assert text.split("\nparameters:")[0] == want.split("\nparameters:")[0]
    assert "cat_boundaries=" in text and "cat_threshold=" in text


def test_nan_and_unseen_categories_route_like_the_reference():
    ref, port, Xv, _, _ = trained("binary", "masked")
    X = Xv.copy()
    rng = np.random.default_rng(3)
    X[rng.random(len(X)) < 0.3, 10] = 999.0        # unseen categories
    X[rng.random(len(X)) < 0.3, 11] = np.nan
    X[rng.random(len(X)) < 0.2, 12] = 57.0
    want = ref.predict(X)
    text = port.model_to_string()
    back = lgt.Booster(model_str=text)
    # save / load / save keeps the trees and the categories
    assert back.model_to_string().split("\nparameters:")[0] \
        == text.split("\nparameters:")[0]
    # the device path (bins: unseen and NaN are bin 0), the raw-value
    # bitsets of the port's own text and the reference's text
    np.testing.assert_allclose(port.predict(X), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(back.predict(X), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        lgt.Booster(model_str=ref.model_to_string()).predict(X), want,
        rtol=0, atol=1e-6)
    # a row whose categories are all unseen or NaN goes right at every
    # categorical node, as one whose values miss every bitset
    np.testing.assert_array_equal(
        back.predict(np.where(np.isin(np.arange(X.shape[1]), CAT_COLS),
                              np.nan, X), pred_leaf=True),
        back.predict(np.where(np.isin(np.arange(X.shape[1]), CAT_COLS),
                              -5.0, X), pred_leaf=True))


def test_valid_set_takes_the_training_categories():
    X, y = guard_data(2000, "binary")
    ds = lgt.Dataset(X[:1500], label=y[:1500], categorical_feature=[
        "Column_10", 11, "Column_12"])
    vs = ds.create_valid(X[1500:], label=y[1500:])
    ds.construct(), vs.construct()
    assert ds.categorical_idx == vs.categorical_idx == CAT_COLS
    assert [ds.bin_mappers[f].bin_type for f in CAT_COLS] \
        == ["categorical"] * 3
    ref = lgb.Dataset(X[:1500], label=y[:1500],
                      categorical_feature=CAT_COLS).construct()
    for f in range(X.shape[1]):
        np.testing.assert_array_equal(ds.binned[:, ds.used_features.index(f)],
                                      np.asarray(ref.binned)[
                                          :, ref.used_features.index(f)])


def test_categorical_feature_parameter_is_ignored_like_the_reference():
    """The JAX package reads categorical columns from the Dataset only: a
    ``categorical_feature`` training parameter leaves every column
    numerical (it is refused only by its streaming engine). The port does
    the same."""
    X, y = guard_data(2000, "binary")
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
              "categorical_feature": "10,11,12"}
    ref = lgb.Booster(params=dict(params), train_set=lgb.Dataset(X, label=y))
    assert not ref.engine.has_categorical
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X, label=y), num_boost_round=2)
    assert not port.engine.has_categorical
    assert categorical_splits(split_lines(port.model_to_string())) == 0
