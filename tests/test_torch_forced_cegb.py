"""Port parity end to end: the split search's options through ``lgt.train``.

Both packages train the same seeded data with the same parameters, the
port replaying the JAX package's draws (GOSS, stochastic rounding, and the
split search's ``feature_fraction_bynode`` / ``extra_trees`` uniforms,
``tests/test_torch_train.py::JaxReplayNoise``). Each option runs on one of
the masked (with bagging and per-tree feature_fraction), GOSS-compacted
and partition paths, and the cases below add forced splits on numerical
and categorical features (with an entry on an unused feature and one that
cannot apply), lazy CEGB under GOSS and with multiclass, extra_trees and
bynode on categorical data, and DART with bynode and interaction
constraints. The check: the model texts' split lines are identical, every
leaf value is within ``LEAF_TOL`` of its tree's largest |leaf| (quantized
gradients at a general scale: XLA fuses ``parent - levels * scale`` into
an FMA, ROADMAP Queue 3), and the holdout predictions within ``PRED_TOL``.

Then the reference's refusals and warnings: lazy CEGB with EFB bundles or
a position-debiased objective is FATAL; forced splits under EFB bundles
are ignored with a warning; the coupled penalty falls to 0 for features a
tree uses; the port's own noise honours ``extra_seed``; the options'
aliases and ``parse_interaction_constraints`` read as the reference's.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.config import \
    parse_interaction_constraints as jax_parse_groups
from lightgbm_tpu_torch.config import Config, parse_interaction_constraints
from test_torch_bundling import bundle_data
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_regression import tree_split_lines
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

ROUNDS = 3
N_FEAT = 12
LEAF_TOL = 2.1e-5
PRED_TOL = 1e-5
BASE = {"objective": "regression", "num_leaves": 15, "learning_rate": 0.5,
        "use_quantized_grad": True, "tpu_leaf_batch": 4, "verbosity": -1,
        "min_data_in_leaf": 10}
# path -> (training rows, params); GOSS starts at iteration 1/lr = 2
PATHS = {
    "masked": (2000, {"tpu_hist_partition": "false", "bagging_fraction": 0.7,
                      "bagging_freq": 1, "feature_fraction": 0.8}),
    "partition": (2000, {"tpu_hist_partition": "true"}),
    "goss": (16_000, {"data_sample_strategy": "goss", "top_rate": 0.1,
                      "other_rate": 0.05, "tpu_goss_compact": True}),
}
SEED = Config({}).objective_seed


def _data(n, seed=0, categorical=False, K=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + 500, N_FEAT))
    w = rng.normal(size=N_FEAT)
    lin = X @ w * 0.3 + 0.8 * X[:, 0] * X[:, 1]
    if categorical:
        X[:, 10] = rng.integers(0, 12, size=len(X))
        X[:, 11] = rng.integers(0, 3, size=len(X))
        lin = lin + np.array([1.5, -1.0, 0.3])[X[:, 11].astype(int)] \
            + (X[:, 10] % 4 == 1) * 1.2
        # NaN fills bin 0, so no left set ties with its complement (ROADMAP
        # Queue 3): the draws of bynode and extra_trees follow the lanes
        X[rng.random(len(X)) < 0.05, 10] = np.nan
        X[rng.random(len(X)) < 0.05, 11] = np.nan
    if K > 1:
        y = np.argmax(X[:, :K] + rng.normal(scale=0.7, size=(len(X), K)),
                      axis=1).astype(np.float64)
    else:
        y = 2.0 * lin + rng.normal(size=len(X))
    return X[:n], y[:n], X[n:], y[n:]


def _forced_file(tmp_path, spec):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(spec))
    return str(path)


def _train_both(params, n, categorical=False, K=1, rounds=ROUNDS):
    X, y, Xv, _ = _data(n, categorical=categorical, K=K)
    cat = [10, 11] if categorical else "auto"
    ref = lgb.train(params, lgb.Dataset(X, label=y, categorical_feature=cat),
                    num_boost_round=rounds)
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X, label=y, categorical_feature=cat),
                     num_boost_round=rounds, noise=JaxReplayNoise(SEED))
    return ref, port, Xv


def _leaf_values(text):
    return [np.array(ln.split("=", 1)[1].split(), np.float64)
            for ln in text.splitlines() if ln.startswith("leaf_value=")]


def check_parity(ref, port, Xv):
    text_p, text_r = port.model_to_string(), ref.model_to_string()
    got, want = tree_split_lines(text_p), tree_split_lines(text_r)
    assert len(got) == len(want) > 0
    assert got == want
    for a, b in zip(_leaf_values(text_p), _leaf_values(text_r)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=LEAF_TOL * np.abs(b).max())
    np.testing.assert_allclose(port.predict(Xv), ref.predict(Xv), rtol=0,
                               atol=PRED_TOL * np.abs(ref.predict(Xv)).max())
    return text_p


OPTIONS = {
    "bynode": ("goss", {"feature_fraction_bynode": 0.5}),
    "extra_trees": ("partition", {"extra_trees": True, "extra_seed": 3}),
    "path_smooth": ("masked", {"path_smooth": 10.0}),
    "feature_contri": ("masked", {"feature_contri": [0.5] * 4 + [1.0] * 8}),
    "interaction": ("partition",
                    {"interaction_constraints": "[0,1,2,5],[2,3,4,5,6],"
                                                "[7,8,9,10,11]"}),
    "cegb": ("masked", {"cegb_penalty_split": 1e-3,
                        "cegb_penalty_feature_coupled": [5.0] * N_FEAT,
                        "cegb_penalty_feature_lazy": [0.01] * N_FEAT}),
    "bynode_extra_masked": ("masked", {"feature_fraction_bynode": 0.6,
                                       "extra_trees": True}),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_reference(name):
    path, opts = OPTIONS[name]
    n, pp = PATHS[path]
    ref, port, Xv = _train_both(dict(BASE, **pp, **opts), n)
    assert port.engine.use_goss_compact == (path == "goss")
    assert port.engine.hist_partition == (path == "partition")
    check_parity(ref, port, Xv)


FORCED = {"feature": 0, "threshold": 0.1,
          "left": {"feature": 1, "threshold": -0.3,
                   "left": {"feature": 40, "threshold": 0.0}},
          "right": {"feature": 2, "threshold": 9.5,
                    "left": {"feature": 3, "threshold": 0.2}}}


@pytest.mark.parametrize("path", ["masked", "partition", "goss"])
def test_forced_splits_match_reference(path, tmp_path):
    """Entry on feature 40 (absent) is skipped with a warning; the right
    entry's threshold 9.5 leaves its right child empty, so it and its
    child are skipped and that leaf grows freely."""
    n, pp = PATHS[path]
    fs = _forced_file(tmp_path, FORCED)
    ref, port, Xv = _train_both(dict(BASE, **pp, forcedsplits_filename=fs),
                                n)
    text = check_parity(ref, port, Xv)
    for tree in text.split("\nTree=")[1:]:
        lines = dict(ln.split("=", 1) for ln in tree.splitlines()
                     if "=" in ln)
        feats = lines["split_feature"].split()
        assert feats[:2] == ["0", "1"]
        assert "3" not in feats[:3]


def test_forced_categorical_splits_match_reference(tmp_path):
    spec = {"feature": 11, "threshold": [0, 2],
            "left": {"feature": 10, "threshold": [1, 5, 9]},
            "right": {"feature": 4, "threshold": 0.0,
                      "right": {"feature": 10, "threshold": 99}}}
    fs = _forced_file(tmp_path, spec)
    ref, port, Xv = _train_both(dict(BASE, **PATHS["masked"][1],
                                     forcedsplits_filename=fs),
                                PATHS["masked"][0], categorical=True)
    text = check_parity(ref, port, Xv)
    first = text.split("\nTree=")[1]
    assert "split_feature=11 10 4" in first


def test_lazy_cegb_under_goss_matches_reference():
    n, pp = PATHS["goss"]
    params = dict(BASE, **pp, cegb_penalty_feature_lazy=[0.02] * N_FEAT,
                  cegb_tradeoff=0.5)
    ref, port, Xv = _train_both(params, n)
    assert port.engine.use_goss_compact
    check_parity(ref, port, Xv)
    U = port.engine._cegb_U.numpy()
    np.testing.assert_array_equal(U, np.asarray(ref.engine._cegb_U))
    assert U[:port.engine.data.n].any() and U[port.engine.data.n:].all()


def test_lazy_cegb_multiclass_matches_reference():
    params = dict(BASE, **PATHS["masked"][1], objective="multiclass",
                  num_class=3, cegb_penalty_feature_lazy=[0.05] * N_FEAT,
                  cegb_penalty_split=1e-3)
    ref, port, Xv = _train_both(params, PATHS["masked"][0], K=3, rounds=3)
    check_parity(ref, port, Xv)
    np.testing.assert_array_equal(port.engine._cegb_U.numpy(),
                                  np.asarray(ref.engine._cegb_U))


def test_categorical_bynode_extra_trees_match_reference():
    params = dict(BASE, **PATHS["partition"][1],
                  feature_fraction_bynode=0.5, extra_trees=True)
    ref, port, Xv = _train_both(params, PATHS["partition"][0],
                                categorical=True)
    check_parity(ref, port, Xv)


def test_dart_bynode_interaction_match_reference():
    params = dict(BASE, **PATHS["masked"][1], boosting="dart",
                  drop_rate=0.5, skip_drop=0.0, feature_fraction_bynode=0.6,
                  interaction_constraints=[[0, 1, 2, 3], [3, 4, 5, 6, 7]])
    ref, port, Xv = _train_both(params, PATHS["masked"][0], rounds=5)
    assert port.engine.drop_iterations > 0
    check_parity(ref, port, Xv)


# ---------------------------------------------------------------------------
# the reference's refusals and warnings, and the port's own state
# ---------------------------------------------------------------------------
def _bundled_data(n=3000):
    X, y, _ = bundle_data(n)
    return X, y


def test_lazy_cegb_with_bundles_is_fatal():
    X, y = _bundled_data()
    with pytest.raises(lgt.LightGBMError, match="cegb_penalty_feature_lazy "
                       "requires the serial single-device learner"):
        lgt.train(dict(BASE, device_type="cpu",
                       cegb_penalty_feature_lazy=[1.0] * X.shape[1]),
                  lgt.Dataset(X, label=y), num_boost_round=1)


def test_lazy_cegb_with_position_bias_is_fatal():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(600, 4))
    rel = rng.integers(0, 3, size=600).astype(float)
    ds = lgt.Dataset(X, label=rel, group=[20] * 30)
    ds.set_position(np.tile(np.arange(20), 30))
    with pytest.raises(lgt.LightGBMError, match="position-state"):
        lgt.train({"objective": "lambdarank", "device_type": "cpu",
                   "verbosity": -1, "enable_bundle": False,
                   "cegb_penalty_feature_lazy": [1.0] * 4}, ds,
                  num_boost_round=1)


def test_forced_splits_with_bundles_are_ignored(tmp_path, capsys):
    X, y = _bundled_data()
    fs = _forced_file(tmp_path, {"feature": 3, "threshold": 0.5})
    params = dict(BASE, device_type="cpu", verbosity=0)
    with_fs = lgt.train(dict(params, forcedsplits_filename=fs),
                        lgt.Dataset(X, label=y), num_boost_round=2)
    assert with_fs.engine.has_bundles
    assert "ignoring forced splits" in capsys.readouterr().err
    plain = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=2)
    assert tree_split_lines(with_fs.model_to_string()) \
        == tree_split_lines(plain.model_to_string())


def test_coupled_penalty_falls_to_zero_for_used_features():
    X, y, _, _ = _data(2000)
    params = dict(BASE, device_type="cpu",
                  cegb_penalty_feature_coupled=[2000.0] * N_FEAT,
                  cegb_tradeoff=0.5)
    eng = lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=3).engine
    used = np.zeros(N_FEAT, bool)
    for t in eng.models:
        used[t.split_feature[:t.num_nodes]] = True
    pen = eng._cegb_pen().numpy()
    np.testing.assert_array_equal(pen == 0, used)
    np.testing.assert_array_equal(pen[~used], 1000.0)
    # the penalty confines the trees to fewer distinct features
    free = lgt.train(dict(BASE, device_type="cpu"), lgt.Dataset(X, label=y),
                     num_boost_round=3).engine
    free_used = {int(f) for t in free.models
                 for f in t.split_feature[:t.num_nodes]}
    assert used.sum() < len(free_used)


def test_port_noise_honours_extra_seed():
    X, y, _, _ = _data(2000)
    texts = [tree_split_lines(lgt.train(
        dict(BASE, device_type="cpu", extra_trees=True, extra_seed=s),
        lgt.Dataset(X, label=y), num_boost_round=2).model_to_string())
        for s in (6, 6, 7)]
    assert texts[0] == texts[1] != texts[2]


@pytest.mark.parametrize("spec", [
    "[0,1,2],[2,3]", "[0, 1], [4]", "", [[1, 2], [3]], str([[0, 5], [6]]),
    [(7,)]])
def test_interaction_groups_parse_as_reference(spec):
    assert parse_interaction_constraints(spec) == jax_parse_groups(spec)


@pytest.mark.parametrize("alias,value", [
    ("colsample_bynode", 0.4), ("sub_feature_bynode", 0.3),
    ("extra_tree", True), ("fc", "0.5,1,1"), ("fp", [1.0, 0.2]),
    ("feature_penalty", "0.3 0.7"), ("fs", "f.json"),
    ("forced_splits", "g.json"), ("path_smooth", 2),
    ("cegb_penalty_feature_lazy", "1,2"), ("interaction_constraints",
                                           [[0, 1], [2]])])
def test_option_aliases_resolve_as_reference(alias, value):
    name = Config.canonical_name(alias)
    assert name == JaxConfig.canonical_name(alias)
    got = getattr(Config({alias: value}), name)
    assert got == getattr(JaxConfig({alias: value}), name)
