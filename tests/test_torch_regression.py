"""End-to-end parity of the non-binary objectives: the port against the JAX
package on the masked full-row path, early stopping, and the reference's
model text and forest.

Both packages train the same seeded data (5,000 rows x 28 Higgs-like
features, holdout 1,000) at 15 leaves, leaf batch 4, learning rate 0.3,
6 rounds, quantized gradients with the reference's own stochastic-rounding
draws replayed in the port (``JaxReplayNoise``, one draw per class tree).
The model texts' ``objective``, ``num_class`` and
``num_tree_per_iteration`` lines are equal in every run.

The objectives split in two. Those whose gradients are exact in float32
(L2 with and without ``reg_sqrt``, L1, quantile, huber, fair, MAPE: no
transcendental function) give the same gradients in both packages. The
others (poisson, gamma, tweedie, the cross-entropies, multiclass) call
``exp``, ``sigmoid`` or ``softmax``, which differ from XLA's by ULPs.
In both packages the leaf values differ in their last bits (the
reference's FMA contraction, ROADMAP Queue 3): up to about 2e-5 of a
tree's largest leaf, the same on the reference's own gradient function
(``python tests/test_torch_regression.py`` prints the reading). So:

- on the masked path and under the row partition, every tree's split
  lines (features, thresholds, decision types, children) must be
  identical and every holdout metric within 1e-4 relative;
- under GOSS the same, except that the trees of a non-exact objective
  may part after the first iteration: GOSS picks its sample by |g * h|
  at the scores, whose last bits follow the leaf values. Where they
  part, the holdout predictions of the iterations before the part must
  agree within 1e-4 relative, and the final holdout metric within 1e-2.

Early stopping must stop at the same best iteration, with identical
trees and the same ``record_evaluation`` history: within 1e-6 relative
for the exact objectives (``l2``), within 1e-4 for the others
(``multi_logloss``: the leaf values' last bits reach 1.6e-5 by the
eighth iteration at learning rate 0.6).

The other paths (the row partition, GOSS with the compacted buffer) run in
``test_torch_objective_paths.py`` and the multiclass objectives in
``test_torch_multiclass.py``, on the helpers here.
"""
import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.boosting import gbdt as port_gbdt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import forest_from_jax
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port while this module runs: the suite
    runs several test processes at once, and torch's default (a thread
    per core in every process) oversubscribes the cores many times over,
    which slows its small ops twentyfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROUNDS = 6
N_FEAT, N_HOLD = 28, 1000
METRIC_RTOL = 1e-4
# final holdout metric of a non-exact objective whose trees part under
# GOSS (its sample follows the last bits of |g * h|)
DRIFT_RTOL = 1e-2
BASE = {"num_leaves": 15, "learning_rate": 0.3, "use_quantized_grad": True,
        "tpu_leaf_batch": 4, "verbosity": -1}
# case -> params of the objective
OBJECTIVES = {
    "regression": {"objective": "regression"},
    "regression_sqrt": {"objective": "regression", "reg_sqrt": True},
    "regression_l1": {"objective": "regression_l1"},
    "huber": {"objective": "huber", "alpha": 1.5},
    "fair": {"objective": "fair", "fair_c": 2.0},
    "poisson": {"objective": "poisson"},
    "quantile": {"objective": "quantile", "alpha": 0.8},
    "mape": {"objective": "mape"},
    "gamma": {"objective": "gamma"},
    "tweedie": {"objective": "tweedie", "tweedie_variance_power": 1.4},
    "cross_entropy": {"objective": "cross_entropy"},
    # the default metric of cross_entropy_lambda (the reference's
    # cross-entropy of the intensity output, clipped at 1 in float32)
    # turns a last-bit difference of a score above 1 into inf; l2 does not
    "cross_entropy_lambda": {"objective": "cross_entropy_lambda",
                             "metric": "l2"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "multiclassova": {"objective": "multiclassova", "num_class": 3},
}
# gradients with no transcendental function: every tree must match
EXACT = ("regression", "regression_sqrt", "regression_l1", "quantile",
         "huber", "fair", "mape")
# path -> (training rows, params); GOSS starts at iteration 1/lr = 3
PATHS = {
    "masked": (5000, {"tpu_hist_partition": "false"}),
    "partition": (5000, {"tpu_hist_partition": "true"}),
    "goss": (16_000, {"data_sample_strategy": "goss", "top_rate": 0.1,
                      "other_rate": 0.05, "tpu_goss_compact": True}),
}
SPLIT_KEYS = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "num_leaves")


def make_data(case, n, seed=0):
    """(X, y, Xv, yv): n training and N_HOLD holdout rows whose label
    suits the case's objective."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + N_HOLD, N_FEAT))
    w = rng.normal(size=N_FEAT)
    lin = X @ w * 0.3 + 0.8 * X[:, 0] * X[:, 1]
    obj = OBJECTIVES[case]["objective"]
    if obj in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(0.15 * lin)).astype(np.float64)
    elif obj == "gamma":
        y = rng.gamma(4.0, np.exp(0.15 * lin) / 4.0)
    elif obj.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-(lin + rng.normal(size=len(X)))))
    elif obj.startswith("multiclass"):
        K = OBJECTIVES[case]["num_class"]
        y = np.argmax(X[:, :K] + rng.normal(scale=0.7, size=(len(X), K)),
                      axis=1).astype(np.float64)
    else:
        y = 2.0 * lin + rng.normal(size=len(X))
    return X[:n], y[:n], X[n:], y[n:]


def header_lines(text):
    """The model text's objective and class lines."""
    return [ln for ln in text.split("\nTree=")[0].splitlines()
            if ln.split("=", 1)[0] in ("num_class", "num_tree_per_iteration",
                                       "objective")]


def tree_split_lines(text):
    """Each tree's split lines of a model text, in tree order."""
    trees = text.split("\nTree=")[1:]
    return [[ln for ln in t.split("\nend of trees")[0].splitlines()
             if ln.split("=", 1)[0] in SPLIT_KEYS] for t in trees]


@contextlib.contextmanager
def reference_gradients():
    """The port's engines built inside take their gradients from the JAX
    package's objective (jitted, on the port's scores), so both packages
    start every iteration from the same gradients."""
    import lightgbm_tpu.config as jcfg
    import lightgbm_tpu.objective as jobj
    create = port_gbdt.create_objective

    def create_with_reference_gradients(config):
        obj = create(config)
        ref = jobj.create_objective(jcfg.Config(dict(config.raw_params)))
        grads = jax.jit(ref.get_gradients)

        def get_gradients(score, label, weight):
            g, h = grads(jnp.asarray(score.numpy()),
                         jnp.asarray(label.numpy()),
                         None if weight is None
                         else jnp.asarray(weight.numpy()))
            return (torch.from_numpy(np.array(g)),
                    torch.from_numpy(np.array(h)))
        obj.get_gradients = get_gradients
        return obj
    port_gbdt.create_objective = create_with_reference_gradients
    try:
        yield
    finally:
        port_gbdt.create_objective = create


def _params(case, path, extra=None):
    return dict(BASE, **PATHS[path][1], **OBJECTIVES[case], **(extra or {}))


def train_reference(case, path, fetched=None):
    """The JAX package's booster after ROUNDS iterations with a holdout;
    ``fetched`` collects its per-iteration tree arrays."""
    X, y, Xv, yv = make_data(case, PATHS[path][0])
    ds = lgb.Dataset(X, label=y)
    ref = lgb.Booster(params=_params(case, path), train_set=ds)
    ref.add_valid(ds.create_valid(Xv, label=yv), "holdout")
    eng = ref.engine
    if fetched is not None:
        fetch = eng._fetch_tree_arrays
        eng._fetch_tree_arrays = lambda st: fetched.append(fetch(st)) or \
            fetched[-1]
    for _ in range(ROUNDS):
        ref.update()
    return ref


def train_port(case, path, ref_gradients=False):
    """The port on the same data with the reference's draws replayed."""
    X, y, Xv, yv = make_data(case, PATHS[path][0])
    pds = lgt.Dataset(X, label=y)
    ctx = reference_gradients() if ref_gradients \
        else contextlib.nullcontext()
    with ctx:
        return lgt.train(dict(_params(case, path), device_type="cpu"), pds,
                         num_boost_round=ROUNDS,
                         valid_sets=[pds.create_valid(Xv, label=yv)],
                         valid_names=["holdout"],
                         noise=JaxReplayNoise(Config({}).objective_seed))


def first_parting_tree(got, want):
    """Index of the first tree whose split lines differ, or None."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


def check_parity(case, path):
    """Train both packages and hold the port to the reference (the rules
    in this module's docstring)."""
    ref = train_reference(case, path)
    port = train_port(case, path)
    re_, pe = ref.engine, port.engine
    K = re_.num_class
    assert pe.num_class == K
    assert pe.hist_partition == re_.hist_partition == (path == "partition")
    assert pe.use_goss_compact == re_._use_goss_compact
    assert pe.grow_cfg.int_hist
    text_p, text_r = port.model_to_string(), ref.model_to_string()
    assert header_lines(text_p) == header_lines(text_r)
    got, want = tree_split_lines(text_p), tree_split_lines(text_r)
    assert len(got) == len(want) == K * ROUNDS
    part = first_parting_tree(got, want)
    assert part is None or (path == "goss" and case not in EXACT
                            and part >= K), part
    Xv = make_data(case, PATHS[path][0])[2]
    if part is not None:
        np.testing.assert_allclose(
            port.predict(Xv, num_iteration=part // K),
            ref.predict(Xv, num_iteration=part // K), rtol=METRIC_RTOL)
    rtol = METRIC_RTOL if part is None else DRIFT_RTOL
    for (_, m_p, v_p, _), (_, m_r, v_r, _) in zip(port.eval_valid(),
                                                  ref.eval_valid()):
        assert m_p == m_r
        assert np.isfinite(v_r)
        assert abs(v_p - v_r) <= rtol * abs(v_r), (m_p, v_p, v_r)
    assert port.predict(Xv).shape == ref.predict(Xv).shape \
        == ((len(Xv), K) if K > 1 else (len(Xv),))
    return ref, port


SINGLE = [c for c in OBJECTIVES if not c.startswith("multiclass")]


@pytest.mark.parametrize("case", SINGLE)
def test_masked_path_matches_reference(case):
    check_parity(case, "masked")


# ---- early stopping --------------------------------------------------------
ES_CASES = {
    "plain": {"early_stopping_round": 3},
    "first_metric_only": {"early_stopping_round": 3, "metric": ["l2", "l1"],
                          "first_metric_only": True},
    "min_delta": {"early_stopping_round": 2,
                  "early_stopping_min_delta": 0.05},
}


def early_stopping_both(case, es_params, rounds=40, lr=0.6):
    """``train`` of both packages with early stopping on a holdout and a
    ``record_evaluation`` history each."""
    n, path_params = PATHS["masked"]
    params = dict(BASE, **path_params, **OBJECTIVES[case], **es_params,
                  learning_rate=lr, num_leaves=31)
    X, y, Xv, yv = make_data(case, n, seed=3)
    ev_r, ev_p = {}, {}
    ds = lgb.Dataset(X, label=y)
    ref = lgb.train(dict(params), ds, num_boost_round=rounds,
                    valid_sets=[ds.create_valid(Xv, label=yv)],
                    valid_names=["holdout"],
                    callbacks=[lgb.record_evaluation(ev_r)])
    pds = lgt.Dataset(X, label=y)
    port = lgt.train(dict(params, device_type="cpu"), pds,
                     num_boost_round=rounds,
                     valid_sets=[pds.create_valid(Xv, label=yv)],
                     valid_names=["holdout"],
                     callbacks=[lgt.record_evaluation(ev_p)],
                     noise=JaxReplayNoise(Config({}).objective_seed))
    return ref, port, ev_r, ev_p, Xv


def check_early_stopping(case, es_params):
    """The same best iteration, identical trees, and the same
    ``record_evaluation`` history: within 1e-6 relative for an exact
    objective, within METRIC_RTOL for the others (the last bits of the
    leaf values)."""
    ref, port, ev_r, ev_p, Xv = early_stopping_both(case, es_params)
    rtol = 1e-6 if case in EXACT else METRIC_RTOL
    assert tree_split_lines(port.model_to_string()) == tree_split_lines(
        ref.model_to_string())
    rounds = len(next(iter(ev_r["holdout"].values())))
    assert 1 < ref.best_iteration < rounds < 40       # it did stop early
    assert port.best_iteration == ref.best_iteration
    assert port.current_iteration() == ref.current_iteration() == rounds
    assert list(ev_p) == list(ev_r) == ["holdout"]
    assert list(ev_p["holdout"]) == list(ev_r["holdout"])
    for metric, hist in ev_r["holdout"].items():
        np.testing.assert_allclose(ev_p["holdout"][metric], hist,
                                   rtol=rtol, err_msg=metric)
    assert port.best_score["holdout"].keys() == ref.best_score[
        "holdout"].keys()
    # predict defaults to the best iteration in both packages
    np.testing.assert_allclose(port.predict(Xv), ref.predict(Xv),
                               rtol=max(rtol, 1e-4), atol=1e-5)
    assert not np.allclose(port.predict(Xv), port.predict(
        Xv, num_iteration=rounds))


@pytest.mark.parametrize("es", list(ES_CASES))
def test_early_stopping_matches_reference_l2(es):
    check_early_stopping("regression", ES_CASES[es])


def test_training_metric_is_evaluated():
    """``is_provide_training_metric``: the train set's metrics come first
    and never stop the run."""
    n, path_params = PATHS["masked"]
    X, y, Xv, yv = make_data("regression", 2000)
    ev = {}
    pds = lgt.Dataset(X, label=y)
    lgt.train(dict(BASE, **path_params, objective="regression",
                   device_type="cpu", is_provide_training_metric=True,
                   early_stopping_round=1, metric="l1"), pds,
              num_boost_round=4, valid_sets=[pds.create_valid(Xv, label=yv)],
              callbacks=[lgt.record_evaluation(ev)])
    assert list(ev) == ["training", "valid_0"]
    assert len(ev["training"]["l1"]) >= 1
    assert ev["training"]["l1"] == sorted(ev["training"]["l1"],
                                          reverse=True)


# ---- the reference's model text and forest ---------------------------------
def check_reference_model(case):
    """The port predicts the reference's model text, and its engine
    predicts the reference's forest carried across by
    ``forest_from_jax``, within 1e-6 (relative above 1) of the
    reference."""
    fetched = []
    ref = train_reference(case, "masked", fetched=fetched)
    Xv = make_data(case, PATHS["masked"][0])[2]
    want = ref.predict(Xv)
    got = lgt.Booster(model_str=ref.model_to_string()).predict(Xv)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    eng = train_port(case, "masked").engine
    trees = forest_from_jax(fetched, float(BASE["learning_rate"]),
                            eng.train_set.bin_mappers,
                            eng.train_set.used_features)
    assert len(trees) == len(ref.engine.models)
    eng.models, eng._stack_cache = trees, None
    eng.init_scores = np.asarray(ref.engine.init_scores, np.float64)
    np.testing.assert_allclose(eng.predict(Xv), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["regression", "quantile", "gamma"])
def test_reference_model_predicts_the_same(case):
    check_reference_model(case)


def test_early_stopping_callback_equals_the_parameter():
    """``callbacks=[early_stopping(n)]`` stops where
    ``early_stopping_round=n`` does, and ``predict`` defaults to the best
    iteration either way."""
    X, y, Xv, yv = make_data("regression", 2000, seed=3)
    out = []
    for es_param, callbacks in ((2, []), (0, [lgt.early_stopping(2)])):
        pds = lgt.Dataset(X, label=y)
        bst = lgt.train(dict(BASE, objective="regression", device_type="cpu",
                             learning_rate=0.6, num_leaves=31,
                             early_stopping_round=es_param), pds,
                        num_boost_round=40,
                        valid_sets=[pds.create_valid(Xv, label=yv)],
                        callbacks=callbacks)
        assert 1 < bst.best_iteration < bst.current_iteration() < 40
        out.append((bst.best_iteration, bst.predict(Xv)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


# ---- the reading behind the tolerances -------------------------------------
def leaf_values(text):
    """Each tree's leaf values of a model text, in tree order."""
    return [np.array([float(v) for ln in t.splitlines()
                      if ln.startswith("leaf_value=")
                      for v in ln.split("=", 1)[1].split()])
            for t in text.split("\nTree=")[1:]]


def reading(cases=tuple(OBJECTIVES), paths=tuple(PATHS)):
    """For each case and path, on the port's own gradients and on the
    reference's: the first tree whose split lines part, each tree's
    largest leaf-value gap over its largest |leaf value| (trees before
    the part), and the holdout metric's relative gap; then the early
    stopping histories' relative gaps per iteration."""
    for case in cases:
        for path in paths:
            ref = train_reference(case, path)
            text_r = ref.model_to_string()
            for own in (True, False):
                port = train_port(case, path, ref_gradients=not own)
                text_p = port.model_to_string()
                part = first_parting_tree(tree_split_lines(text_p),
                                          tree_split_lines(text_r))
                gaps = [float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                        for a, b in zip(leaf_values(text_p),
                                        leaf_values(text_r))][:part]
                metric = [abs(v_p - v_r) / abs(v_r) for (_, _, v_p, _), (
                    _, _, v_r, _) in zip(port.eval_valid(),
                                         ref.eval_valid())]
                print(f"{case} {path} {'own' if own else 'reference'} "
                      f"gradients: first parting tree {part}, leaf gaps "
                      f"{' '.join(f'{g:.1e}' for g in gaps)}, metric gap "
                      f"{' '.join(f'{m:.2e}' for m in metric)}", flush=True)
    for case, es in (("regression", ES_CASES["plain"]),
                     ("multiclass", {"early_stopping_round": 3})):
        _, _, ev_r, ev_p, _ = early_stopping_both(case, es)
        for m, hist in ev_r["holdout"].items():
            gap = np.abs(np.subtract(ev_p["holdout"][m], hist)) / np.abs(hist)
            print(f"early stopping {case} {m} history gaps "
                  f"{' '.join(f'{g:.1e}' for g in gap)}", flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_regression.py
    #     [CASE ...]
    import sys
    torch.set_num_threads(1)
    reading(tuple(sys.argv[1:]) or tuple(OBJECTIVES))
