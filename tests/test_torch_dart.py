"""Port parity: DART boosting (``boosting="dart"``), from the drop draws to
the model.

- ``_select_drop``: the same host draws from ``RandomState(drop_seed)``,
  so over 50 iterations both packages drop the same iterations, at the
  uniform and weight-proportional probabilities, with ``skip_drop`` 0 and
  0.5 and ``max_drop`` 2 (the tree weights evolve as DART rescales them);
- the dropped trees' contribution: on the same trees, a drop set of
  iterations out of order traverses to the reference's bits (the
  reference pads its stack to a power of two with zero-valued one-leaf
  trees; the per-class sums run in tree order from +0.0, so the padding
  adds +0.0), one tree per class under multiclass;
- end to end, with the reference's draws replayed (``JaxReplayNoise``)
  and quantized gradients, 10 rounds at drop rate 0.5: regression,
  binary (the sigmoid that gives XLA's bits), 3-class multiclass,
  ``xgboost_dart_mode``, DART under GOSS past its switch-over, and DART
  under EFB (the dropped trees traverse the logical bins while the
  training matrix is the bundled one; the counterpart of
  ``tests/test_bundling.py::test_dart_under_efb_matches_unbundled``).
  Every case: the same iterations drop trees, the same split lines, and
  holdout predictions within 1e-5;
- the port's own invariants on the regression model: its internal score
  is the sum of its stored trees (within 1e-5: the score was blended in
  float32 while the trees were rescaled in float64), the model text
  round-trips, ``rollback_one_iter`` gives the scores of the trees that
  stay, and ``predict`` after a rescale reads the shrunk leaves (the stack
  cache is keyed by the model version, not the tree count).
"""
import types

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu.boosting.dart as jdart
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting.dart import DART
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops.predict import forest_predict_binned
from lightgbm_tpu_torch.tree import Tree
from test_torch_bundling import bundle_data
from test_torch_regression import _one_torch_thread, tree_split_lines  # noqa
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

ROUNDS = 10
TOL = 1e-5
N_TRAIN, N_HOLD, N_FEAT = 3000, 500, 10
BASE = {"boosting": "dart", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.3, "use_quantized_grad": True,
        "tpu_leaf_batch": 4, "drop_rate": 0.5, "skip_drop": 0.2,
        "verbosity": -1}
CASES = {
    "regression": {"objective": "regression"},
    "binary": {"objective": "binary"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "xgboost_dart_mode": {"objective": "regression",
                          "xgboost_dart_mode": True},
    # GOSS starts at iteration 1 / learning rate = 3
    "goss": {"objective": "regression", "data_sample_strategy": "goss",
             "top_rate": 0.2, "other_rate": 0.1},
    "efb": {"objective": "binary"},
}


def case_data(case, seed=0):
    """(X, y) of N_TRAIN + N_HOLD rows for the case's objective; EFB's
    are bundleable (one-hot groups and sparse columns)."""
    if case == "efb":
        X, y, _ = bundle_data(N_TRAIN + N_HOLD, seed=seed)
        return X, y
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_TRAIN + N_HOLD, N_FEAT))
    lin = X @ rng.normal(size=N_FEAT) * 0.4 + 0.8 * X[:, 0] * X[:, 1]
    obj = CASES[case]["objective"]
    if obj == "binary":
        y = (lin + rng.normal(size=len(X)) > 0).astype(np.float64)
    elif obj == "multiclass":
        y = np.argmax(X[:, :3] + rng.normal(scale=0.7, size=(len(X), 3)),
                      axis=1).astype(np.float64)
    else:
        y = 2.0 * lin + rng.normal(size=len(X))
    return X, y


_RUNS = {}


def trained(case):
    """Both packages on the case's data (cached for the module):
    (reference, port, holdout X, drop sets of the reference per
    iteration)."""
    if case not in _RUNS:
        X, y = case_data(case)
        params = dict(BASE, **CASES[case])
        ref = lgb.Booster(params=dict(params), train_set=lgb.Dataset(
            X[:N_TRAIN], label=y[:N_TRAIN]))
        eng = ref.engine
        drops = []
        select = eng._select_drop
        eng._select_drop = lambda: drops.append(select()) or drops[-1]
        for _ in range(ROUNDS):
            ref.update()
        port = lgt.train(dict(params, device_type="cpu"),
                         lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN]),
                         num_boost_round=ROUNDS,
                         noise=JaxReplayNoise(Config({}).objective_seed))
        _RUNS[case] = (ref, port, X[N_TRAIN:], drops)
    return _RUNS[case]


# ---- drop draws -------------------------------------------------------------
def _drop_sequence(select_drop, config, iters=50, lr=0.3):
    """The drop sets of ``iters`` iterations of DART's weight bookkeeping
    around ``select_drop`` (the engine's own arithmetic, no trees)."""
    st = types.SimpleNamespace(config=config, _iter_weights=[],
                               _sum_weight=0.0,
                               _rng_drop=np.random.RandomState(
                                   config.drop_seed))
    out = []
    for _ in range(iters):
        drop = select_drop(st)
        out.append(drop.tolist())
        k = len(drop)
        if k == 0:
            st._iter_weights.append(lr)
            st._sum_weight += lr
            continue
        new_mult, old_mult = 1.0 / (k + 1.0), k / (k + 1.0)
        for i in drop:
            st._iter_weights[int(i)] *= old_mult
        st._iter_weights.append(lr * new_mult)
        st._sum_weight = float(np.sum(st._iter_weights))
    return out


@pytest.mark.parametrize("setting", [
    {"uniform_drop": True, "skip_drop": 0.0},
    {"uniform_drop": False, "skip_drop": 0.0},
    {"uniform_drop": False, "skip_drop": 0.5},
    {"uniform_drop": False, "skip_drop": 0.0, "max_drop": 2}])
def test_select_drop_matches_reference(setting):
    import lightgbm_tpu.config as jcfg
    p = dict(drop_rate=0.3, drop_seed=7, **setting)
    got = _drop_sequence(DART._select_drop, Config(dict(p)))
    want = _drop_sequence(jdart.DART._select_drop, jcfg.Config(dict(p)))
    assert got == want
    assert sum(map(len, got)) > 10
    if "max_drop" in setting:
        assert max(map(len, got)) == 2


# ---- the dropped trees' contribution ----------------------------------------
def _as_port_tree(t) -> Tree:
    return Tree(**{f: getattr(t, f)
                   for f in Tree.__dataclass_fields__})


@pytest.mark.parametrize("case", ["regression", "multiclass"])
def test_drop_contribution_bit_equal(case):
    ref, port, _, _ = trained(case)
    re_, pe = ref.engine, port.engine
    K = re_.num_class
    drop_iters = [7, 2, 5]
    idx = [i * K + c for i in drop_iters for c in range(K)]
    pad = 1 << (len(idx) - 1).bit_length()
    st_r, cls_r = re_._stack_model_list(idx, pad_count=pad,
                                        pad_leaves=re_.config.num_leaves)
    want, _ = jdart.forest_predict_binned(
        st_r, re_._logical_bins(), re_.feat_num_bin, re_.feat_has_nan,
        cls_r, K)
    saved = pe.models
    try:
        # the reference's trees in the port's engine (restored after)
        pe.models = [_as_port_tree(t) for t in re_.models]
        st_p, cls_p, depth = pe._stack_model_list(idx)
    finally:
        pe.models = saved
        pe._invalidate_forest_cache()
    assert cls_p.tolist() == np.asarray(cls_r)[:len(idx)].tolist()
    got, _ = forest_predict_binned(st_p, pe._logical_bins(),
                                   pe.feat_num_bin, pe.feat_has_nan, depth,
                                   K, class_index=cls_p)
    n = pe.data.n
    want = np.asarray(want)[:n]
    assert np.any(want != 0.0)
    np.testing.assert_array_equal(got[:n].numpy().view(np.int32),
                                  want.view(np.int32))


# ---- end to end -------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_dart_matches_reference(case):
    ref, port, Xv, drops = trained(case)
    pe = port.engine
    assert isinstance(pe, DART) and pe.has_bundles == (case == "efb")
    dropped = [d for d in drops if len(d)]
    assert pe.drop_iterations == len(dropped) >= 3
    assert pe._iter_weights == pytest.approx(ref.engine._iter_weights,
                                             rel=1e-12)
    got = tree_split_lines(port.model_to_string())
    want = tree_split_lines(ref.model_to_string())
    assert len(got) == len(want) == ROUNDS * pe.num_class
    assert got == want
    np.testing.assert_allclose(port.predict(Xv, raw_score=True),
                               ref.predict(Xv, raw_score=True),
                               rtol=0, atol=TOL)


# ---- the port's own invariants ----------------------------------------------
def test_internal_score_is_the_sum_of_the_trees():
    _, port, _, _ = trained("regression")
    pe = port.engine
    n = pe.data.n
    X, _ = case_data("regression")
    from_trees = port.predict(X[:N_TRAIN], raw_score=True)
    np.testing.assert_allclose(pe.score[:n, 0].numpy(), from_trees,
                               rtol=0, atol=TOL)


def test_model_text_round_trip():
    _, port, Xv, _ = trained("regression")
    loaded = lgt.Booster(model_str=port.model_to_string())
    np.testing.assert_allclose(loaded.predict(Xv), port.predict(Xv),
                               rtol=0, atol=TOL)


def test_rollback_one_iter():
    X, y = case_data("regression", seed=3)
    params = dict(BASE, **CASES["regression"], device_type="cpu")
    bst = lgt.train(params, lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN]),
                    num_boost_round=6)
    eng = bst.engine
    before = eng.models[:5]
    bst.rollback_one_iter()
    assert bst.current_iteration() == 5 and len(eng.models) == 5
    assert all(a is b for a, b in zip(eng.models, before))
    assert len(eng._iter_weights) == 5
    assert eng._sum_weight == pytest.approx(sum(eng._iter_weights))
    # the scores are rebuilt from the trees that stay
    np.testing.assert_allclose(
        eng.score[:eng.data.n, 0].numpy(),
        bst.predict(X[:N_TRAIN], raw_score=True), rtol=0, atol=1e-6)
    bst.update()
    assert bst.current_iteration() == 6


def test_predict_after_a_rescale_reads_the_shrunk_leaves():
    """The stack cache must not serve leaves from before an in-place
    rescale: an iteration that drops tree 0 rescales it, and rolling that
    iteration back restores the tree count but not the old leaves."""
    X, y = case_data("regression", seed=4)
    params = dict(BASE, **CASES["regression"], device_type="cpu")
    bst = lgt.train(params, lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN]),
                    num_boost_round=4)
    eng = bst.engine
    Xv = X[N_TRAIN:]
    before = bst.predict(Xv, raw_score=True)          # fills the cache
    leaf0 = eng.models[0].leaf_value.copy()
    eng._select_drop = lambda: np.array([0])
    bst.update()
    bst.rollback_one_iter()
    assert len(eng.models) == 4
    np.testing.assert_allclose(eng.models[0].leaf_value, leaf0 * 0.5)
    after = bst.predict(Xv, raw_score=True)
    host = lgt.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(after, host.predict(Xv, raw_score=True),
                               rtol=0, atol=TOL)
    assert np.max(np.abs(after - before)) > 1e-3
