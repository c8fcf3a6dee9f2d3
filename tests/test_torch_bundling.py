"""Port parity: Exclusive Feature Bundling (EFB), from the plan to the model.

Both packages get the same inputs:

- the host plan: ``find_bundles`` / ``plan_bundles`` / ``apply_bundles`` /
  ``build_expand_maps`` give the same arrays on the same binned matrix,
  with exclusive columns, with conflicts at ``max_conflict_rate`` 0.2,
  against the 256-bin cap of a bundle, and on the sampled branch (a
  ``sample_cnt`` below the row count, where the full-data check evicts
  what the sample missed);
- the expansion: ``expand_hist`` is bit-equal to the reference's on the
  same physical histograms, float32 and scaled integer levels, where the
  bundled columns are sparse continuous ones with many non-default bins
  (their default-bin residual is a float sum whose order matters: the
  port writes out the order of XLA's CPU backend, ``sum_bins``);
- ``grow_tree`` on a bundled matrix with integer gradient levels at a
  power-of-two scale: identical tree arrays and leaf ids on the masked
  path and the row partition;
- end to end at the defaults (``enable_bundle`` on, ``max_conflict_rate``
  0) on bundleable data: 3 normal columns, 32 one-hot indicators in 4
  groups of 8 (a ninth state, absent, leaves a row's group all zero) and
  8 sparse continuous columns in 2 exclusive groups of 4, with the
  reference's draws replayed: masked, GOSS past its switch-over (under
  EFB both packages keep GOSS on the masked path) and the partition, on
  quantized and exact gradients and 3-class multiclass: identical split
  lines and holdout predictions within 1e-5. Multiclass under GOSS is the
  one exception, as in ``test_torch_regression.py``: GOSS samples rows by
  |g * h| at scores whose last bits follow the softmax's ULPs, so its
  trees may part after the first GOSS iteration (on this data they do,
  bundled and unbundled alike). Before the part the holdout predictions
  agree within 1e-4;
- the port's old fault: with 3% of the indicators flipped on, the
  indicators are not exclusive at ``max_conflict_rate`` 0 (only the
  sparse continuous columns bundle) and bundle at 0.2, where the
  reference trains other trees; the port now trains the reference's 0.2
  trees;
- ``enable_bundle=False`` trains unbundled, and on quantized gradients
  the bundled and unbundled models are the same trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import bundling as jb
from lightgbm_tpu.learner.serial import GrowConfig as JaxGrowConfig
from lightgbm_tpu.learner.serial import grow_tree as jax_grow_tree
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import bundling as tb
from lightgbm_tpu_torch.learner import serial as ts
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

ROUNDS = 5
TOL = 1e-5
POW2_SCALE = np.array([2.0 ** -6, 2.0 ** -5, 1.0], np.float32)
BASE = {"num_leaves": 15, "learning_rate": 0.5, "tpu_leaf_batch": 4,
        "verbosity": -1}
# GOSS starts at iteration 1 / learning rate = 2 of the 5
PATHS = {
    "masked": {},
    "goss": {"data_sample_strategy": "goss", "top_rate": 0.2,
             "other_rate": 0.1},
    "partition": {"tpu_hist_partition": "true"},
}
SETTINGS = {
    "binary_quantized": {"objective": "binary", "use_quantized_grad": True},
    "binary_exact": {"objective": "binary"},
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "use_quantized_grad": True},
}
SPLIT_KEYS = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "num_leaves")
N_TRAIN, N_HOLD = 3000, 1000


def bundle_data(n, seed=0, flip=0.0):
    """3 normal columns; 4 groups of 8 one-hot indicators (state 8 of 9:
    the whole group 0), with ``flip`` of the indicator entries set to 1;
    2 groups of 4 sparse continuous columns (one of each group non-zero
    on 2/3 of the rows, signed values on a grid of 0.25, so a column has
    tens of bins and its zero bin sits inside the range). Returns X, the
    binary label and the logit."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 3))
    groups = []
    for _ in range(4):
        sel = rng.integers(0, 9, size=n)
        m = (sel[:, None] == np.arange(8)[None, :]).astype(np.float64)
        if flip:
            m[rng.random(m.shape) < flip] = 1.0
        groups.append(m)
    for _ in range(2):
        sel = rng.integers(0, 6, size=n)
        v = np.round(rng.lognormal(size=(n, 4)) * 4) / 4
        v *= np.where(rng.random((n, 4)) < 0.3, -1.0, 1.0)
        groups.append(np.where(sel[:, None] == np.arange(4)[None, :], v,
                               0.0))
    X = np.hstack([dense] + groups)
    logit = (X[:, 0] + X[:, 3] - X[:, 12] + 0.5 * X[:, 35] - 0.7 * X[:, 40]
             + 0.3 * X[:, 1] * X[:, 2])
    y = (logit + rng.normal(size=n) > 0).astype(np.float64)
    return X, y, logit


def split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.split("=", 1)[0] in SPLIT_KEYS]


def _plan_inputs(X, max_bin=255):
    """The engine's probe inputs from the port's own binning: binned,
    num_bins, eligible (numerical, no missing), default bins."""
    ds = lgt.Dataset(X, label=np.zeros(len(X)),
                     params={"max_bin": max_bin}).construct()
    ms = [ds.bin_mappers[f] for f in ds.used_features]
    eligible = np.array([m.bin_type != "categorical"
                         and m.missing_type == "none" for m in ms])
    default = np.array([m.value_to_bin(0.0) for m in ms], np.int32)
    return ds.binned, ds.feature_num_bins(), eligible, default


# ---- (a) the host plan ------------------------------------------------------
PLAN_CASES = {
    "exclusive": dict(flip=0.0, rate=0.0, sample_cnt=50_000),
    "conflicts_0.2": dict(flip=0.03, rate=0.2, sample_cnt=50_000),
    "sampled": dict(flip=0.002, rate=0.01, sample_cnt=400),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_arrays_equal_reference(case):
    c = PLAN_CASES[case]
    X, _, _ = bundle_data(N_TRAIN, seed=1, flip=c["flip"])
    binned, nb, eligible, default = _plan_inputs(X)
    kw = dict(max_conflict_rate=c["rate"], sample_cnt=c["sample_cnt"],
              seed=3)
    got = tb.find_bundles(binned, nb, eligible, default, **kw)
    want = jb.find_bundles(binned, nb, eligible, default, **kw)
    assert got == want and len(got) >= 2
    if case == "sampled":
        # the full-data check evicted members the sample let in
        sampled_only = tb.find_bundles(binned, nb, eligible, default,
                                       **dict(kw, sample_cnt=N_TRAIN))
        assert got != sampled_only
    _assert_same_plan(binned, nb, default, got)


def test_plan_respects_the_256_bin_cap():
    """Sparse continuous columns of about 100 bins each, all exclusive:
    a bundle holds at most 256 bins, so two share a column at most."""
    rng = np.random.default_rng(2)
    n = 4000
    sel = rng.integers(0, 7, size=n)
    v = np.round(rng.normal(size=(n, 6)) * 32) / 4
    X = np.where(sel[:, None] == np.arange(6)[None, :], v, 0.0)
    binned, nb, eligible, default = _plan_inputs(X)
    assert (nb > 90).all()
    got = tb.find_bundles(binned, nb, eligible, default)
    want = jb.find_bundles(binned, nb, eligible, default)
    assert got == want and len(got) >= 2
    assert all(1 + sum(int(nb[f]) - 1 for f in b) <= 256 for b in got)
    assert max(len(b) for b in got) == 2
    _assert_same_plan(binned, nb, default, got)


def _assert_same_plan(binned, nb, default, bundles):
    tp, jp = (tb.plan_bundles(nb, default, bundles),
              jb.plan_bundles(nb, default, bundles))
    assert tp.n_phys == jp.n_phys and tp.bundles == jp.bundles
    for k in ("phys_col", "start", "default_bin", "bundled",
              "phys_num_bin"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k),
                                      err_msg=k)
    np.testing.assert_array_equal(tb.apply_bundles(binned, tp),
                                  jb.apply_bundles(binned, jp))
    B = max(8, -(-max(int(nb.max()), int(tp.phys_num_bin.max())) // 8) * 8)
    for got, want in zip(tb.build_expand_maps(tp, nb, B),
                         jb.build_expand_maps(jp, nb, B)):
        np.testing.assert_array_equal(got, want)


# ---- (b) the expansion ------------------------------------------------------
@jax.jit
def reference_expand(hists, totals, map_pf, map_pb, map_valid, at_def):
    """The reference's ``expand_hist`` (lightgbm_tpu/learner/serial.py,
    the closure in ``grow_tree``), line for line."""
    g = hists[:, map_pf, map_pb, :]
    g = jnp.where(map_valid[None, :, :, None], g, 0.0)
    resid = totals[:, None, :] - jnp.sum(g, axis=2)
    return g + (at_def[None, :, :, None] * resid[:, :, None, :])


@pytest.mark.parametrize("values", ["f32", "scaled_int"])
@pytest.mark.parametrize("B", [64, 256])
def test_expand_hist_bit_equal(values, B):
    X, _, _ = bundle_data(N_TRAIN, seed=4)
    # at B = 64 the columns take 15 bins, so a group of 4 fits a bundle
    binned, nb, eligible, default = _plan_inputs(
        X, max_bin=15 if B == 64 else 255)
    plan = tb.plan_bundles(nb, default, tb.find_bundles(
        binned, nb, eligible, default, max_bundle_bins=B))
    # the sparse continuous columns are bundled, with many non-default
    # bins each (their residual is a long float sum)
    cont = np.arange(35, 43)
    assert plan.bundled[cont].all() and (nb[cont] > 8).all()
    rng = np.random.default_rng(B)
    C, Fp = 6, plan.n_phys
    if values == "f32":
        h = rng.normal(size=(C, Fp, B, 3)) * rng.uniform(
            0.01, 100, size=(C, Fp, B, 3))
        tot = rng.normal(size=(C, 3)) * 1e3
    else:
        h = rng.integers(-900, 900, size=(C, Fp, B, 3)) * np.float32(0.0371)
        tot = rng.integers(-40_000, 40_000, size=(C, 3)) * np.float32(0.0371)
    h, tot = h.astype(np.float32), tot.astype(np.float32)
    maps = tb.build_expand_maps(plan, nb, B)
    want = np.asarray(reference_expand(jnp.asarray(h), jnp.asarray(tot),
                                       *(jnp.asarray(m) for m in maps)))
    bm = ts.BundleMaps.from_plan(plan, nb, B, torch.device("cpu"))
    got = ts.expand_hist(torch.from_numpy(h), torch.from_numpy(tot),
                         bm).numpy()
    assert got.shape == (C, len(nb), B, 3)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # torch's own sum order would part from the reference here
    g = torch.from_numpy(h)[:, bm.map_pf, bm.map_pb]
    g = torch.where(bm.map_valid[None, :, :, None], g, 0.0)
    t = torch.from_numpy(tot)[:, None, :]
    assert not torch.equal((t - g.sum(dim=2))[:, bm.bundled],
                           (t - ts.sum_bins(g))[:, bm.bundled])


@pytest.mark.parametrize("n", [8, 24, 40, 72, 256, 264, 1100])
def test_sum_bins_is_xla_order(n):
    """On every entry, and on the first k entries with the rest zero (what
    the expansion passes: a bundled feature's bins past its count)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, 5, n, 3)) * rng.uniform(
        0.1, 100, size=(3, 5, n, 3))).astype(np.float32)
    for k in sorted({1, 2, 17, 33, n // 2, n - 1, n}):
        xk = x.copy()
        xk[:, :, k:] = 0.0
        want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=2))(xk))
        got = ts.sum_bins(torch.from_numpy(xk[:, :, :k].copy()), n).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=str(k))


# ---- (c) grow_tree ----------------------------------------------------------
@pytest.mark.parametrize("leaf_batch,partition", [(1, False), (8, False),
                                                  (8, True)])
def test_grow_tree_bundled_bit_equal(leaf_batch, partition):
    X, y, _ = bundle_data(8192, seed=6)
    binned, nb, eligible, default = _plan_inputs(X)
    plan = tb.plan_bundles(nb, default, tb.find_bundles(
        binned, nb, eligible, default))
    phys = tb.apply_bundles(binned, plan)
    B = 256
    rng = np.random.default_rng(leaf_batch + partition)
    g = np.clip(np.round(2 * (y - 0.5) + rng.normal(size=len(y))), -8, 8)
    h = rng.integers(1, 4, size=len(y))
    m = (rng.random(len(y)) < 0.9).astype(np.float32)
    vals = np.stack([g * m, h * m, m], 1).astype(np.float32)
    F = len(nb)
    hn = np.zeros(F, bool)
    allowed = np.ones(F, bool)
    kw = dict(num_leaves=31, num_bins=B, leaf_batch=leaf_batch,
              partition=partition, min_data_in_leaf=5, has_bundles=True)
    maps = tb.build_expand_maps(plan, nb, B)
    jbundle = tuple(jnp.asarray(a) for a in maps) + tuple(
        jnp.asarray(getattr(plan, k)) for k in
        ("bundled", "phys_col", "start", "default_bin"))
    jt, jl = jax_grow_tree(jnp.asarray(phys), jnp.asarray(vals),
                           jnp.asarray(nb), jnp.asarray(hn),
                           jnp.asarray(allowed),
                           JaxGrowConfig(rows_per_block=1024, **kw),
                           bundle=jbundle,
                           chan_scale=jnp.asarray(POW2_SCALE))
    tt, tl = ts.grow_tree(torch.from_numpy(phys.T.copy()),
                          torch.from_numpy(vals), torch.from_numpy(nb),
                          torch.from_numpy(hn), torch.from_numpy(allowed),
                          ts.GrowConfig(int_hist=True, **kw),
                          chan_scale=torch.from_numpy(POW2_SCALE),
                          bundle=ts.BundleMaps.from_plan(
                              plan, nb, B, torch.device("cpu")))
    assert int(tt["num_leaves"]) == 31
    # splits on bundled features occur, and route through their columns
    used = np.asarray(jt["split_feature"])
    assert plan.bundled[used].any()
    for k, v in tt.items():
        got = np.asarray(v.cpu() if torch.is_tensor(v) else v)
        want = np.asarray(jt[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ---- (d) end to end ---------------------------------------------------------
_RUNS = {}


def trained(setting, path, flip=0.0, extra=None):
    """Both packages on the same bundleable data (cached for the module):
    (reference, port, holdout X)."""
    extra = dict(extra or {})
    key = (setting, path, flip, tuple(sorted(extra.items())))
    if key not in _RUNS:
        X, y, logit = bundle_data(N_TRAIN + N_HOLD, flip=flip)
        if setting == "multiclass":
            y = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])) \
                .astype(np.float64)
        params = dict(BASE, **SETTINGS[setting], **PATHS[path], **extra)
        ref = lgb.Booster(params=dict(params), train_set=lgb.Dataset(
            X[:N_TRAIN], label=y[:N_TRAIN]))
        for _ in range(ROUNDS):
            ref.update()
        port = lgt.train(dict(params, device_type="cpu"),
                         lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN]),
                         num_boost_round=ROUNDS,
                         noise=JaxReplayNoise(Config({}).objective_seed))
        _RUNS[key] = (ref, port, X[N_TRAIN:])
    return _RUNS[key]


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_port_matches_reference_at_the_defaults(setting, path):
    ref, port, Xv = trained(setting, path)
    re_, pe = ref.engine, port.engine
    assert re_.has_bundles and pe.has_bundles
    assert pe.bundle_plan.bundles == re_.bundle_plan.bundles
    assert pe.bundle_plan.n_phys == re_.bundle_plan.n_phys < 43
    # the device rows are the bundled matrix; the tree arrays are logical
    assert pe.data.bins_t.shape[0] == pe.bundle_plan.n_phys
    assert pe.num_features == 43
    assert pe.hist_partition == (path == "partition")
    assert not pe.use_goss_compact and not re_._use_goss_compact
    lines = split_lines(port.model_to_string())
    K = pe.num_class
    assert len(lines) == len(SPLIT_KEYS) * ROUNDS * K
    want = split_lines(ref.model_to_string())
    feats = {int(f) for ln in lines if ln.startswith("split_feature=")
             for f in ln.split("=", 1)[1].split()}
    assert feats & set(np.nonzero(pe.bundle_plan.bundled)[0].tolist())
    if lines != want and setting == "multiclass" and path == "goss":
        part = next(i for i, (a, b) in enumerate(zip(lines, want))
                    if a != b) // len(SPLIT_KEYS)
        assert part >= K, part
        it = part // K
        np.testing.assert_allclose(port.predict(Xv, num_iteration=it),
                                   ref.predict(Xv, num_iteration=it),
                                   rtol=1e-4)
        return
    assert lines == want
    dp = np.abs(port.predict(Xv) - ref.predict(Xv)).max()
    assert dp <= TOL, dp


def test_max_conflict_rate_trains_the_reference_model():
    """The old fault: at max_conflict_rate 0.2 the reference bundles the
    flipped indicators and trains other trees than at 0.0; the port took
    0.2 and trained the 0.0 trees. Now it trains the reference's."""
    ref2, port2, Xv = trained("binary_quantized", "masked", flip=0.03,
                              extra={"max_conflict_rate": 0.2})
    ref0, port0, _ = trained("binary_quantized", "masked", flip=0.03)
    indicators = slice(3, 35)
    for eng in (ref0.engine, port0.engine):
        assert not eng.bundle_plan.bundled[indicators].any()
    for eng in (ref2.engine, port2.engine):
        assert eng.bundle_plan.bundled[indicators].all()
    assert port2.engine.bundle_plan.bundles \
        == ref2.engine.bundle_plan.bundles
    lines2 = split_lines(port2.model_to_string())
    assert lines2 == split_lines(ref2.model_to_string())
    assert lines2 != split_lines(ref0.model_to_string())
    assert split_lines(port0.model_to_string()) \
        == split_lines(ref0.model_to_string())
    dp = np.abs(port2.predict(Xv) - ref2.predict(Xv)).max()
    assert dp <= TOL, dp


def test_partition_under_conflicts_routes_like_the_reference():
    """Lossy bundles on the partition: the moved rows fall back to the
    default bin as the reference's routing does."""
    ref, port, _ = trained("binary_quantized", "partition", flip=0.03,
                           extra={"max_conflict_rate": 0.2})
    assert port.engine.has_bundles and port.engine.hist_partition
    assert split_lines(port.model_to_string()) \
        == split_lines(ref.model_to_string())


def test_enable_bundle_false_trains_unbundled():
    ref, port, Xv = trained("binary_quantized", "masked",
                            extra={"enable_bundle": False})
    assert not ref.engine.has_bundles and not port.engine.has_bundles
    assert port.engine.bundle_plan is None
    assert port.engine.data.bins_t.shape[0] == 43
    lines = split_lines(port.model_to_string())
    assert lines == split_lines(ref.model_to_string())
    # with exact (integer) sums bundling changes no split
    _, bundled, _ = trained("binary_quantized", "masked")
    assert bundled.engine.has_bundles
    assert split_lines(bundled.model_to_string()) == lines


def test_valid_set_and_early_stopping_stay_logical():
    X, y, _ = bundle_data(N_TRAIN + N_HOLD, seed=8)
    params = dict(BASE, objective="binary", use_quantized_grad=True,
                  metric="auc", early_stopping_round=3)
    evals = {}
    for name, pkg, extra in (("ref", lgb, {}),
                             ("port", lgt, {"device_type": "cpu"})):
        ds = pkg.Dataset(X[:N_TRAIN], label=y[:N_TRAIN])
        res = {}
        kw = ({"noise": JaxReplayNoise(Config({}).objective_seed)}
              if pkg is lgt else {})
        bst = pkg.train(dict(params, **extra), ds, num_boost_round=8,
                        valid_sets=[ds.create_valid(X[N_TRAIN:],
                                                    label=y[N_TRAIN:])],
                        callbacks=[pkg.record_evaluation(res)], **kw)
        assert bst.engine.has_bundles
        evals[name] = (res["valid_0"]["auc"], bst.best_iteration,
                       bst.predict(X[N_TRAIN:]))
    np.testing.assert_allclose(evals["port"][0], evals["ref"][0], rtol=0,
                               atol=1e-6)
    assert evals["port"][1] == evals["ref"][1]
    np.testing.assert_allclose(evals["port"][2], evals["ref"][2], rtol=0,
                               atol=TOL)
