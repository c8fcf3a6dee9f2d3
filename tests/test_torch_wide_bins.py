"""Port parity: wide bins (``max_bin`` > 255 and ``max_bin_by_feature``
entries above 255, uint16 bin ids).

The same numpy-seeded inputs go through the JAX package (on the CPU, as
its own tests run it: its wide route leaves Pallas for the XLA einsum
histogram, ``compact_rows_xla`` and ``move_rows_xla``) and the port:

- bins: dense (the native row-major pass and the NumPy plain route),
  sparse, pandas (a 1,000-category column) and text-file input, and
  device ingest on the CPU device: mappers and binned matrices equal the
  reference's, dtype included; ``max_bin`` 255 stays uint8; more than
  65,536 bins is FATAL by the feature's name;
- kernel A's plain version against ``build_histogram`` (K lanes, -1 rows)
  at B = 300, 1,024, 4,096 and 40,000 (ids >= 32,768): int mode bit-equal,
  f32 mode within the order tolerance of ``test_torch_histogram.py``;
- the plain versions of B and B′ on uint16 columns with ids >= 32,768
  against ``compact_rows_xla`` / ``move_rows_xla``, bit-equal;
- ``_cumsum_bins`` bit-equal to ``jnp.cumsum`` at B = 8 to 65,536 (the
  recursive blocked scan) and ``sum_bins`` at 4,096; the split search
  (numerical and categorical scans, the categorical sort and bitsets,
  extra_trees' threshold draw) bit-equal at B = 4,096;
- ``grow_tree`` on the same uint16 bins and integer gradient levels at a
  power-of-two scale: identical tree arrays on the masked, GOSS-compact
  and partition paths;
- end to end at ``max_bin`` 1023 with the reference's draws replayed:
  identical split lines on every path the port trains, forced splits
  included;
- round trips of uint16 datasets (``save_binary``, ``subset``,
  ``convert.device_data_from_jax``) and, at ``max_bin`` 255, the
  flagship's model text byte-equal to the one before wide bins.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting.gbdt import _DeviceData
from lightgbm_tpu.learner.serial import GrowConfig as JaxGrowConfig
from lightgbm_tpu.learner.serial import grow_tree as jax_grow_tree
from lightgbm_tpu.ops import compact as jc
from lightgbm_tpu.ops import partition as jp
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.histogram import build_histogram
from lightgbm_tpu_torch.boosting.gbdt import DeviceData
from lightgbm_tpu_torch.convert import device_data_from_jax
from lightgbm_tpu_torch.learner import serial as tserial
from lightgbm_tpu_torch.learner.serial import GrowConfig, grow_tree
from lightgbm_tpu_torch.ops import compact as tc
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import partition as tp
from lightgbm_tpu_torch.ops import split as ts
from test_torch_grow import EXACT_KEYS, POW2_SCALE
from test_torch_split_options import _search_inputs
from test_torch_regression import _one_torch_thread  # noqa: F401
from test_torch_regression import tree_split_lines
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa
from test_torch_train import synth_higgs

CPU = torch.device("cpu")
SEED = lgt.config.Config({}).objective_seed
BY_FEATURE = [15, 1023, 4095, 255, 300, 63]


def _mapper_fields(m):
    return (m.bin_type, m.num_bin, m.missing_type, m.default_bin,
            None if m.bin_upper_bound is None
            else np.asarray(m.bin_upper_bound).tobytes(),
            None if m.bin_to_cat is None
            else np.asarray(m.bin_to_cat).tobytes())


def _matrix(n, seed=0):
    """6 columns: normal, with NaN, 1,000 categories (column 2), few
    distinct values, zero-heavy, wide range; float32-exact (device ingest
    casts to float32, ``test_torch_ingest.py``)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[rng.random(n) < 0.1, 1] = np.nan
    X[:, 2] = rng.integers(0, 1000, size=n)
    X[:, 3] = np.round(X[:, 3] * 50)
    X[rng.random(n) < 0.4, 4] = 0.0
    X[:, 5] = rng.exponential(size=n) * 1e4
    return X.astype(np.float32).astype(np.float64)


def _write_csv(path, X, y):
    with open(path, "w") as f:
        f.write(",".join(["y"] + [f"c{j}" for j in range(X.shape[1])])
                + "\n")
        for yy, row in zip(y, X):
            f.write(",".join([f"{yy:.17g}"] + ["NA" if np.isnan(v)
                                               else f"{v:.17g}"
                                               for v in row]) + "\n")


def _inputs(kind, tmp_path):
    """(port input, reference input, Dataset kwargs) of one input kind."""
    if kind == "dense":                    # > 65,536 rows: the native pass
        X = _matrix(70_001)
        return X, X, dict(categorical_feature=[2])
    X = _matrix(6000, seed=1)
    y = (X[:, 0] > 0).astype(np.float64)
    if kind == "sparse":
        X[np.random.default_rng(3).random(X.shape) < 0.5] = 0.0
        M = sp.csr_matrix(np.nan_to_num(X, nan=0.0))
        return M, M, dict(categorical_feature=[2])
    if kind == "pandas":
        import pandas as pd
        df = pd.DataFrame(X, columns=[f"c{j}" for j in range(6)])
        df["c2"] = pd.Categorical(X[:, 2].astype(int))
        return df, df, dict(label=y)
    path = str(tmp_path / "wide.csv")
    _write_csv(path, X, y)
    return path, path, dict(params={"header": True, "label_column": 0})


@pytest.mark.parametrize("kind,params", [
    ("dense", {"max_bin": 1023}),
    ("dense", {"max_bin_by_feature": BY_FEATURE}),
    ("dense", {"max_bin": 255}),
    ("sparse", {"max_bin": 1023}),
    ("pandas", {"max_bin": 1023}),
    ("text", {"max_bin": 4095}),
])
def test_bins_equal_reference(kind, params, tmp_path):
    """Mappers and bins equal the reference's, dtype included; the dense
    matrix also equals the NumPy plain route and device ingest."""
    x_p, x_r, kw = _inputs(kind, tmp_path)
    kw_p = dict(kw, params={**kw.get("params", {}), **params})
    ref = lgb.Dataset(x_r, **kw_p).construct()
    port = lgt.Dataset(x_p, **kw_p).construct()
    assert port.used_features == ref.used_features
    for a, b in zip(port.bin_mappers, ref.bin_mappers):
        assert _mapper_fields(a) == _mapper_fields(b)
    wide = max(port.feature_num_bins()) > 256
    assert wide == (params.get("max_bin", 0) != 255)
    assert port.binned.dtype == np.asarray(ref.binned).dtype \
        == (np.uint16 if wide else np.uint8)
    np.testing.assert_array_equal(port.binned, np.asarray(ref.binned))
    if kind == "pandas":
        assert port.bin_mappers[2].num_bin > 256     # 1,000 categories
    if kind != "dense":
        return
    plain = np.stack([port.bin_mappers[f].values_to_bins_plain(x_p[:, f])
                      for f in port.used_features], axis=1)
    np.testing.assert_array_equal(port.binned, plain)
    dev = lgt.Dataset(x_p, **dict(kw_p, params={
        **kw_p["params"], "tpu_ingest_device": "true",
        "device_type": "cpu"})).construct()
    ing = dev.device_ingested()
    assert ing is not None and ing.bins.dtype == (torch.uint16 if wide
                                                  else torch.uint8)
    assert dev.binned_dtype() == port.binned.dtype
    np.testing.assert_array_equal(ing.bins.numpy(), port.binned)
    np.testing.assert_array_equal(ing.bins_t.numpy(), port.binned.T)


def test_more_than_65536_bins_is_fatal():
    X = np.random.default_rng(0).normal(size=(70_000, 2))
    ds = lgt.Dataset(X, params={"max_bin": 70_000, "min_data_in_bin": 1,
                                "verbosity": -1})
    with pytest.raises(lgt.LightGBMError, match="Column_0 has 7.* bins"):
        ds.construct()


# ---- the three kernels' plain versions ----------------------------------
def _hist_ref(bins, vals, leaf, ids, B, rpb):
    """The reference's wide histogram, one ``build_histogram`` a lane."""
    out = []
    for lid in ids:
        m = (leaf == lid).astype(np.float32)[:, None]
        out.append(np.asarray(build_histogram(
            jnp.asarray(bins), jnp.asarray(vals * m), num_bins=B,
            rows_per_block=rpb)))
    return np.stack(out)


@pytest.mark.parametrize("int_levels", [True, False])
@pytest.mark.parametrize("n,F,B", [(2048, 4, 300), (2048, 4, 1024),
                                   (2048, 3, 4096), (1024, 2, 40_000)])
def test_histogram_plain_matches_reference(n, F, B, int_levels):
    rng = np.random.default_rng(B + F)
    bins = rng.integers(0, B, size=(n, F)).astype(np.uint16)
    if B > 32_768:
        bins[: n // 2] |= np.uint16(0x8000)           # ids >= 32,768
        bins = np.minimum(bins, B - 1).astype(np.uint16)
    vals = (rng.integers(-3, 4, size=(n, 3)) if int_levels
            else rng.normal(size=(n, 3))).astype(np.float32)
    vals[:, -1] = (rng.random(n) < 0.8).astype(np.float32)
    leaf = rng.integers(0, 5, size=n).astype(np.int32)
    leaf[rng.random(n) < 0.2] = -1                     # span rows
    ids = np.array([3, 0, -1, 4], np.int32)
    out = th.multi_leaf_histogram(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(vals.T.copy()),
        torch.from_numpy(leaf), torch.from_numpy(ids), num_bins=B,
        int_mode=int_levels).numpy()
    live = ids >= 0
    ref = _hist_ref(bins, vals, leaf, ids[live], B, 256)
    assert out.shape == (4, F, B, 3) and not out[~live].any()
    if int_levels:
        np.testing.assert_array_equal(out[live], ref)
    else:
        vb = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
        tol = 2.0 ** -20 * np.abs(vb).sum(axis=0)
        assert np.all(np.abs(out[live] - ref) <= tol)
        np.testing.assert_array_equal(out[live][..., -1], ref[..., -1])


def test_histogram_wrapper_bounds_by_dtype():
    bins = torch.zeros((2, 64), dtype=torch.uint16)
    vals = torch.zeros((3, 64))
    lid = torch.zeros(64, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    assert th.multi_leaf_histogram(bins, vals, lid, ids,
                                   num_bins=65_536).shape[2] == 65_536
    with pytest.raises(ValueError):
        th.multi_leaf_histogram(bins, vals, lid, ids, num_bins=65_537)
    with pytest.raises(ValueError):
        th.multi_leaf_histogram(bins.to(torch.uint8), vals, lid, ids,
                                num_bins=257)


def _u16_cols(n, F, C, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 65_536, size=(F, n)).astype(np.uint16)
    assert (bins >= 32_768).any()
    return bins, rng.normal(size=(C, n)).astype(np.float32), rng


@pytest.mark.parametrize("frac", [0.3, 1.0])
def test_compaction_plain_uint16_bit_equal(frac):
    bins, vals, rng = _u16_cols(4096, 5, 4, seed=1)
    mask = rng.random(4096) < frac
    out_cols = jc.compaction_out_cols(int(mask.sum()), 512, 1024)
    plan = jc.plan_compaction(jnp.asarray(mask), 512, out_cols)
    jb, jv = jc.compact_rows_xla(jnp.asarray(bins), jnp.asarray(vals), *plan,
                                 out_cols=out_cols, rows_per_block=512)
    tb, tv = tc.compact_by_mask(torch.from_numpy(bins),
                                torch.from_numpy(vals),
                                torch.from_numpy(mask), out_cols)
    assert tb.dtype == torch.uint16
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))


def test_partition_move_plain_uint16_bit_equal():
    bins, vals, rng = _u16_cols(3000, 4, 3, seed=2)
    old = rng.integers(0, 6, size=3000).astype(np.int32)
    new = np.where(rng.random(3000) < 0.4, old + 6, old).astype(np.int32)
    dest, n_front, cum = jp.plan_split_move(jnp.asarray(new != old))
    jb, jv = jp.move_rows_xla([jnp.asarray(bins), jnp.asarray(vals)], dest,
                              axis=1)
    jl = jp.move_rows_xla([jnp.asarray(new)], dest)[0]
    (tb, tv, tl), tnf, tcum = tp.partition_move(
        torch.from_numpy(bins), torch.from_numpy(vals),
        torch.from_numpy(old), torch.from_numpy(new))
    assert tb.dtype == torch.uint16 and int(tnf) == int(n_front)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tcum.numpy(), np.asarray(cum))
    # the span gather keeps uint16
    sb, _, _ = tp.slice_spans(tb, tv, tl, torch.tensor([0, 1000]),
                              torch.tensor([10, 20]), 256)
    assert sb.dtype == torch.uint16
    np.testing.assert_array_equal(sb.numpy()[:, :256], tb.numpy()[:, :256])


# ---- the split search's sums -----------------------------------------------
@pytest.mark.parametrize("B", [8, 256, 288, 289, 300, 1024, 4096, 65_536])
def test_cumsum_bins_matches_xla_order(B):
    rng = np.random.default_rng(B)
    F = 4 if B <= 4096 else 1
    x = (rng.normal(size=(2, F, B, 3))
         * rng.uniform(0.1, 100, size=(2, F, 1, 1))).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=2))(x))
    out = ts._cumsum_bins(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


def test_sum_bins_at_4096_is_xla_order():
    rng = np.random.default_rng(4096)
    x = (rng.normal(size=(2, 3, 4096, 3))
         * rng.uniform(0.1, 100, size=(2, 3, 4096, 3))).astype(np.float32)
    for k in (1000, 4096):
        xk = x.copy()
        xk[:, :, k:] = 0.0
        want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=2))(xk))
        got = tserial.sum_bins(torch.from_numpy(xk[:, :, :k].copy()),
                               4096).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("categorical,extra_trees", [(False, False),
                                                     (True, True)])
def test_find_best_split_at_4096_bins(categorical, extra_trees):
    d = _search_inputs(C=4, F=8, B=4096, seed=9)
    kw = dict(min_data_in_leaf=5, lambda_l2=0.5, has_categorical=categorical,
              max_cat_to_onehot=4, min_data_per_group=5,
              extra_trees=extra_trees)
    pos = tuple(int(i) for i in np.flatnonzero(d["is_cat"]))
    jcfg = js.SplitConfig(**kw, cat_positions=pos if categorical else ())
    nb, hn, ic = (jnp.asarray(d[k]) for k in ("nb", "hn", "is_cat"))

    def one(h, s, a, e):
        return js.find_best_split(h, s, nb, hn, a, jcfg, is_cat=ic,
                                  extra_u=e)
    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(d[k]) for k in (
        "hist", "sums", "allowed", "extra_u")))
    t = torch.from_numpy
    out = ts.find_best_split(
        t(d["hist"]), t(d["sums"]), t(d["nb"]), t(d["hn"]), t(d["allowed"]),
        ts.SplitConfig(**kw), is_cat=t(d["is_cat"]) if categorical else None,
        cat_idx=t(np.flatnonzero(d["is_cat"])) if categorical else None,
        extra_u=t(d["extra_u"]))
    assert set(out) <= set(ref) and np.isfinite(out["gain"].numpy()).all()
    if categorical:
        assert out["cat_bitset"].shape[-1] == 4096 // 32
    for k, v in out.items():
        a = np.asarray(ref[k])
        np.testing.assert_array_equal(
            v.numpy(), a.astype(np.int64) if k == "cat_bitset" else a,
            err_msg=k)


# ---- grow_tree -------------------------------------------------------------
@pytest.mark.parametrize("path", ["masked", "compact", "partition"])
def test_grow_tree_uint16_bit_equal(path):
    rng = np.random.default_rng(11)
    n, F, B = 4096, 5, 1024
    nb = rng.integers(300, B + 1, size=F).astype(np.int32)
    hn = rng.random(F) < 0.3
    bins = (rng.random((n, F)) * nb[None, :]).astype(np.uint16)
    g = rng.integers(-2, 3, size=n).astype(np.float32)
    h = rng.integers(0, 4, size=n).astype(np.float32)
    m = (rng.random(n) < 0.9).astype(np.float32)
    vals = np.stack([g * m, h * m, m], 1)
    compact, partition = path == "compact", path == "partition"
    jcfg = JaxGrowConfig(num_leaves=15, num_bins=B, rows_per_block=1024,
                         leaf_batch=4, hist_compact=compact,
                         min_data_in_leaf=5, partition=partition)
    tcfg = GrowConfig(num_leaves=15, num_bins=B, leaf_batch=4, int_hist=True,
                      hist_compact=compact, min_data_in_leaf=5,
                      partition=partition)
    j = dict(chan_scale=jnp.asarray(POW2_SCALE))
    t = dict(chan_scale=torch.from_numpy(POW2_SCALE))
    hv = vals
    if compact:
        idx = np.sort(rng.choice(n, 2048, replace=False))
        hv = vals[idx]
        j["compact"] = (jnp.asarray(bins[idx]), None, jnp.asarray(hv))
        t["compact_bins_t"] = torch.from_numpy(bins[idx].T.copy())
    allowed = np.ones(F, bool)
    jt, jl = jax_grow_tree(jnp.asarray(bins), jnp.asarray(hv),
                           jnp.asarray(nb), jnp.asarray(hn),
                           jnp.asarray(allowed), jcfg, **j)
    tt, tl = grow_tree(torch.from_numpy(bins.T.copy()), torch.from_numpy(hv),
                       torch.from_numpy(nb), torch.from_numpy(hn),
                       torch.from_numpy(allowed), tcfg, **t)
    assert int(tt["num_leaves"]) == 15
    for k in EXACT_KEYS + ("leaf_value", "split_gain", "internal_value"):
        np.testing.assert_array_equal(np.asarray(tt[k]), np.asarray(jt[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ---- end to end ------------------------------------------------------------
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 1023,
        "learning_rate": 0.5, "use_quantized_grad": True,
        "tpu_leaf_batch": 4, "min_data_in_leaf": 10, "verbosity": -1}
# case -> (rows, params); GOSS starts at iteration 1 / learning rate = 2
CASES = {
    "masked": (3000, {"bagging_fraction": 0.7, "bagging_freq": 1,
                      "feature_fraction": 0.8}),
    "exact": (3000, {"use_quantized_grad": False}),
    "goss": (16_000, {"data_sample_strategy": "goss", "top_rate": 0.1,
                      "other_rate": 0.05, "tpu_goss_compact": True}),
    "partition": (3000, {"tpu_hist_partition": "true"}),
    "multiclass": (3000, {"objective": "multiclass", "num_class": 3}),
    "dart": (3000, {"boosting": "dart", "drop_rate": 0.5,
                    "skip_drop": 0.0}),
    "categorical": (3000, {"max_cat_to_onehot": 4}),
    "bynode_extra_trees": (3000, {"feature_fraction_bynode": 0.6,
                                  "extra_trees": True}),
    "by_feature": (3000, {"max_bin_by_feature": [1023, 15, 300, 63, 4095,
                                                 255]}),
}


def _case_data(name, n):
    """Numerical columns on a 0.01 grid: some 400 bins each (uint16 ids)
    and several rows a bin, so that the last-bit differences of the leaf
    values (ROADMAP Queue 3, "FMA contraction") part no near-tied
    thresholds in three rounds."""
    rng = np.random.default_rng(7)
    X = np.round(rng.normal(size=(n + 500, 6)), 2)
    lin = X[:, 0] + 0.8 * X[:, 1] * X[:, 2] - 0.5 * np.abs(X[:, 3])
    cat = []
    if name == "categorical":
        X[:, 5] = rng.integers(0, 1000, size=len(X))
        X[rng.random(len(X)) < 0.05, 5] = np.nan
        lin = lin + (X[:, 5] % 7 < 2) * 1.5
        cat = [5]
    if name == "multiclass":
        y = np.digitize(lin, np.quantile(lin, [1 / 3, 2 / 3])).astype(float)
    else:
        y = (lin + rng.normal(size=len(X)) > 0).astype(np.float64)
    return X[:n], y[:n], X[n:], cat


@pytest.mark.parametrize("name", list(CASES))
def test_end_to_end_split_lines_equal(name):
    n, extra = CASES[name]
    X, y, Xv, cat = _case_data(name, n)
    params = dict(BASE, **extra)
    ref = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=cat),
                    num_boost_round=3)
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X, label=y, categorical_feature=cat),
                     num_boost_round=3, noise=JaxReplayNoise(SEED))
    eng = port.engine
    assert eng.data.bins.dtype == torch.uint16 and eng.B > 256
    assert eng.use_goss_compact == (name == "goss")
    assert eng.hist_partition == (name == "partition")
    if name == "categorical":
        assert eng.train_set.bin_mappers[5].num_bin > 256
        assert "cat_threshold=" in port.model_to_string()
    got = tree_split_lines(port.model_to_string())
    want = tree_split_lines(ref.model_to_string())
    assert len(got) == len(want) > 0 and got == want
    np.testing.assert_allclose(port.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=1e-5)


def test_efb_with_a_wide_unbundled_column():
    """Sparse exclusive columns bundle (at most 256 bins a bundle) beside
    a wide dense column that stays on its own: the physical matrix is
    uint16 and the trees are the reference's."""
    rng = np.random.default_rng(9)
    n = 3000
    X = np.zeros((n + 500, 10))
    X[:, :2] = rng.normal(size=(n + 500, 2))
    grp = rng.integers(0, 9, size=n + 500)
    for j in range(8):
        X[grp == j, 2 + j] = rng.normal(size=(grp == j).sum()) + 2.0
    y = (X[:, 0] + X[:, 2] - X[:, 5] + rng.normal(size=n + 500) > 0) \
        .astype(np.float64)
    params = dict(BASE)
    ref = lgb.train(params, lgb.Dataset(X[:n], label=y[:n]),
                    num_boost_round=3)
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X[:n], label=y[:n]), num_boost_round=3,
                     noise=JaxReplayNoise(SEED))
    eng = port.engine
    assert eng.has_bundles and eng.bundle_plan.n_phys < 10
    assert eng.bundle_plan.phys_num_bin.max() > 256
    assert eng.data.bins.dtype == torch.uint16
    assert tree_split_lines(port.model_to_string()) == \
        tree_split_lines(ref.model_to_string())
    np.testing.assert_allclose(port.predict(X[n:]), ref.predict(X[n:]),
                               rtol=0, atol=1e-5)


def test_forced_splits_at_wide_bins(tmp_path):
    """A forced-split table at max_bin 1023: thresholds become uint16-range
    bins, its rounds read the children's counts from the wide histograms;
    the trees are the reference's."""
    import json
    X, y, Xv, _ = _case_data("masked", 3000)
    spec = {"feature": 0, "threshold": 0.3,
            "left": {"feature": 1, "threshold": -0.2},
            "right": {"feature": 2, "threshold": 0.7}}
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(spec))
    params = dict(BASE, forcedsplits_filename=str(path))
    ref = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=3)
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X, label=y), num_boost_round=3,
                     noise=JaxReplayNoise(SEED))
    got = tree_split_lines(port.model_to_string())
    assert got == tree_split_lines(ref.model_to_string())
    assert all(t[1].startswith("split_feature=0 1 2") for t in got)


# ---- round trips -----------------------------------------------------------
def test_save_binary_and_subset_keep_uint16(tmp_path):
    X = _matrix(3000, seed=4)
    y = (X[:, 0] > 0).astype(np.float64)
    ds = lgt.Dataset(X, label=y, categorical_feature=[2],
                     params={"max_bin": 1023}).construct()
    assert ds.binned.dtype == np.uint16
    path = str(tmp_path / "wide.bin")
    ds.save_binary(path)
    back = lgt.Dataset(path).construct()
    assert back.binned.dtype == np.uint16
    np.testing.assert_array_equal(back.binned, ds.binned)
    idx = np.arange(0, 3000, 3)
    sub = ds.subset(idx)
    assert sub.binned.dtype == np.uint16
    np.testing.assert_array_equal(sub.binned, ds.binned[idx])
    p = dict(BASE, device_type="cpu")
    a = lgt.train(p, back, num_boost_round=2)
    b = lgt.train(p, lgt.Dataset(X, label=y, categorical_feature=[2],
                                 params={"max_bin": 1023}),
                  num_boost_round=2)
    assert tree_split_lines(a.model_to_string()) == \
        tree_split_lines(b.model_to_string())


def test_device_data_from_jax_keeps_uint16():
    """The reference's padded uint16 matrix carries across as uint16 (a
    byte view would double the columns). Off the TPU the reference's
    engine keeps no feature-major copy of it (``bins_t`` None); a uint16
    one given to the converter stays uint16 too."""
    X = _matrix(2000, seed=5)
    y = (X[:, 0] > 0).astype(np.float64)
    ref = _DeviceData(lgb.Dataset(X, label=y, params={"max_bin": 1023})
                      .construct(), 1024, transposed=False)
    assert np.asarray(ref.bins).dtype == np.uint16 and ref.bins_t is None
    conv = device_data_from_jax(np.asarray(ref.bins), None,
                                np.asarray(ref.label), ref.n)
    port = DeviceData.from_dataset(
        lgt.Dataset(X, label=y, params={"max_bin": 1023}), 1024, CPU,
        transposed=True)
    assert conv.bins.dtype == torch.uint16 and conv.bins_t is None
    assert tuple(conv.bins.shape) == tuple(port.bins.shape) == (2048, 6)
    np.testing.assert_array_equal(conv.bins.numpy(), port.bins.numpy())
    conv_t = device_data_from_jax(np.asarray(ref.bins),
                                  np.asarray(ref.bins).T.copy(),
                                  np.asarray(ref.label), ref.n)
    assert conv_t.bins_t.dtype == torch.uint16
    np.testing.assert_array_equal(conv_t.bins_t.numpy(), port.bins_t.numpy())


# the flagship's CPU model text at max_bin 255 (test_torch_train's settings
# at 4,000 rows, 12 rounds) before wide bins: its SHA-256
FLAGSHIP_255_SHA = ("bdc013a45fecea3d84a66b2067eb819"
                    "86c1e34b5e55bbc1974b6a66542c5efd7")


def test_max_bin_255_model_text_unchanged():
    X, y = synth_higgs(4000, 28)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 255,
              "learning_rate": 0.1, "use_quantized_grad": True,
              "data_sample_strategy": "goss", "tpu_leaf_batch": 8,
              "verbosity": -1, "device_type": "cpu"}
    bst = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=12)
    assert bst.engine.data.bins.dtype == torch.uint8
    digest = hashlib.sha256(bst.model_to_string().encode()).hexdigest()
    assert digest == FLAGSHIP_255_SHA
