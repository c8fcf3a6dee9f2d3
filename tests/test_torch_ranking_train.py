"""Learning to rank end to end: the port against the JAX package.

Both packages train the same seeded ranking data through ``train`` with a
holdout: 62 training queries of 1 to 60 documents (1,904 rows x 12
features; one query of one document, one of relevance all zero),
relevance 0-4, and a holdout of 150 queries of 4 to 20 documents; the
GOSS-compaction runs use 530 training queries (16,232 rows), the
smallest size at which the compacted histogram buffer is smaller than
the padded rows (position debiasing keeps GOSS masked, as the reference
does, and runs it on the 62 queries).
31 leaves, leaf batch 8, learning rate 0.1 (0.5 under GOSS, which starts
at iteration 1 / learning rate), 6 rounds, the holdout's ndcg@1, @3 and
@5 after every round, and the JAX package's own draws replayed in the
port (``JaxReplayNoise``: rank_xendcg's gammas and GOSS's sample).

Quantized gradients without stochastic rounding use 16 gradient bins:
with the default 4 (two gradient levels) and no rounding noise nearly
every lambdarank gradient rounds to level 0, and the holdout ndcg of
both packages falls after the first tree. There the trees part at
once, at a near tie of two splits' gains (the reference's float32 gains
differ from the port's in their last bits, ROADMAP Queue 3):
``test_default_bins_part_only_at_a_near_tie`` finds that node and holds
the gains within 1e-5 of each other.

The rules: with quantized gradients on the masked, partition, bagging and
GOSS-compacted paths, for lambdarank and rank_xendcg, every tree's split
lines (features, thresholds, decision types, children) are identical and
the holdout metric history agrees within 1e-4 relative (the leaf values
differ in their last bits, as for every objective; test_torch_regression
.py). The trees may part only where the last bits decide between two
splits: the first node where they differ must be a near tie (each
package's chosen split within 1e-5 of the other's gain), named with its
tree in the assert message. The port's gradients differ from the
reference's by float32 ULPs (test_torch_ranking.py), so the quantization
scale, ``max |g| / levels``, can differ by an ULP too, and with it every
gain of a tree (on this data the bagging run parts at tree 3). With
exact gradients or position debiasing the gradients' last bits reach the
gains directly. After a part the predictions of the iterations before the
parting tree agree within 1e-4 relative and the final metric within 1e-2.
Every run checks the model text's objective line and a text round trip,
and the port predicts the reference's model text; its engine predicts
the reference's forest carried across by ``forest_from_jax``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import forest_from_jax
from test_torch_regression import (first_parting_tree, header_lines,
                                   tree_split_lines)
from test_torch_train import JaxReplayNoise, _reference_metrics_off  # noqa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (test_torch_regression
    .py says why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROUNDS = 6
METRIC_RTOL = 1e-4
DRIFT_RTOL = 1e-2
BASE = {"num_leaves": 31, "learning_rate": 0.1, "use_quantized_grad": True,
        "stochastic_rounding": False, "num_grad_quant_bins": 16,
        "tpu_leaf_batch": 8, "eval_at": [1, 3, 5], "verbosity": -1}
OBJECTIVES = {
    "lambdarank": {"objective": "lambdarank"},
    "rank_xendcg": {"objective": "rank_xendcg"},
    "lambdarank_exact": {"objective": "lambdarank",
                         "use_quantized_grad": False},
    "lambdarank_position": {"objective": "lambdarank"},
    "lambdarank_unbiased": {"objective": "lambdarank",
                            "lambdarank_unbiased": True},
}
PATHS = {
    "masked": (62, {"tpu_hist_partition": "false"}),
    "partition": (62, {"tpu_hist_partition": "true"}),
    "bagging": (62, {"bagging_fraction": 0.7, "bagging_freq": 1}),
    "goss": (530, {"data_sample_strategy": "goss", "top_rate": 0.1,
                   "other_rate": 0.05, "tpu_goss_compact": True,
                   "learning_rate": 0.5}),
}
# position debiasing keeps GOSS masked in both packages: no need of the
# compaction's size
PATHS["goss_masked"] = (62, PATHS["goss"][1])


def rank_data(n_queries, seed=0):
    """Training and holdout sets: (X, rel, counts, Xv, relv, vcounts,
    position)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 61, size=n_queries)
    counts[4] = 1
    vcounts = rng.integers(4, 21, size=150)
    n, nv = int(counts.sum()), int(vcounts.sum())
    X = rng.normal(size=(n + nv, 12))
    rel = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] - 0.5 * X[:, 2] * X[:, 3]
                           + rng.normal(scale=0.7, size=n + nv) + 1.5), 0, 4)
    qb = np.concatenate([[0], np.cumsum(counts)])
    rel[qb[7]:qb[8]] = 0
    position = np.concatenate([np.arange(c) for c in counts]) % 10
    return X[:n], rel[:n], counts, X[n:], rel[n:], vcounts, position


def run_both(case, path, extra=None, rounds=ROUNDS):
    """``train`` of both packages on the case's data with a holdout and a
    ``record_evaluation`` history each."""
    n_queries, path_params = PATHS[path]
    params = dict(BASE, **path_params, **OBJECTIVES[case], **(extra or {}))
    X, y, g, Xv, yv, gv, pos = rank_data(n_queries)
    out = {}
    replay = JaxReplayNoise(Config({}).objective_seed)
    for name, pkg, kw in (("ref", lgb, {}), ("port", lgt, {"noise": replay})):
        ds = pkg.Dataset(X, label=y, group=g)
        if case == "lambdarank_position":
            ds.set_position(pos)
        ev = {}
        p = dict(params, device_type="cpu") if pkg is lgt else dict(params)
        bst = pkg.train(p, ds, num_boost_round=rounds,
                        valid_sets=[ds.create_valid(Xv, label=yv, group=gv)],
                        valid_names=["holdout"],
                        callbacks=[pkg.record_evaluation(ev)], **kw)
        out[name] = (bst, ev)
    return out, Xv


def near_tie(port, ref, part):
    """The first node of tree ``part`` where the packages' splits differ:
    its description, and whether the two chosen gains are within 1e-5 of
    each other."""
    a, b = port.engine.models[part], ref.engine.models[part]
    node = next(i for i in range(min(a.num_nodes, b.num_nodes))
                if (a.split_feature[i], a.threshold_bin[i])
                != (b.split_feature[i], b.threshold_bin[i]))
    ga, gb = float(a.split_gain[node]), float(b.split_gain[node])
    what = (f"tree {part} node {node}: the port splits feature "
            f"{a.split_feature[node]} at bin {a.threshold_bin[node]} (gain "
            f"{ga!r}), the reference feature {b.split_feature[node]} at bin "
            f"{b.threshold_bin[node]} (gain {gb!r})")
    return what, abs(ga - gb) <= 1e-5 * abs(gb)


def check_parity(case, path):
    runs, Xv = run_both(case, path)
    (ref, ev_r), (port, ev_p) = runs["ref"], runs["port"]
    re_, pe = ref.engine, port.engine
    assert pe.hist_partition == re_.hist_partition == (path == "partition")
    assert pe.use_goss_compact == re_._use_goss_compact == (path == "goss")
    assert pe.objective.is_ranking
    assert (pe._pos_state is not None) == (case in ("lambdarank_position",
                                                    "lambdarank_unbiased"))
    text_p, text_r = port.model_to_string(), ref.model_to_string()
    assert header_lines(text_p) == header_lines(text_r)
    assert f"objective={OBJECTIVES[case]['objective']}" in text_p
    got, want = tree_split_lines(text_p), tree_split_lines(text_r)
    assert len(got) == len(want) == ROUNDS
    part = first_parting_tree(got, want)
    if part is not None:
        what, tie = near_tie(port, ref, part)
        assert tie, f"{case} {path}: {what}"
    assert list(ev_p["holdout"]) == list(ev_r["holdout"]) == [
        "ndcg@1", "ndcg@3", "ndcg@5"]
    if part is None:
        for m, hist in ev_r["holdout"].items():
            np.testing.assert_allclose(ev_p["holdout"][m], hist,
                                       rtol=METRIC_RTOL, err_msg=m)
    else:
        np.testing.assert_allclose(
            port.predict(Xv, num_iteration=max(part, 1)),
            ref.predict(Xv, num_iteration=max(part, 1)),
            rtol=METRIC_RTOL, atol=1e-6,
            err_msg=f"{case} {path}: before the part at {what}")
        for m, hist in ev_r["holdout"].items():
            assert abs(ev_p["holdout"][m][-1] - hist[-1]) <= DRIFT_RTOL * abs(
                hist[-1]), (f"{case} {path}: parts at {what}", m)
    assert ev_r["holdout"]["ndcg@5"][-1] > 0.75
    # raw scores; the text round trip and the reference's text predict
    pred = port.predict(Xv)
    assert pred.shape == (len(Xv),) and np.isfinite(pred).all()
    np.testing.assert_allclose(lgt.Booster(model_str=text_p).predict(Xv),
                               pred, rtol=0, atol=1e-6)
    np.testing.assert_allclose(lgt.Booster(model_str=text_r).predict(Xv),
                               ref.predict(Xv), rtol=0, atol=1e-6)
    return part


@pytest.mark.parametrize("case,path", [
    ("lambdarank", "masked"), ("lambdarank", "partition"),
    ("lambdarank", "bagging"), ("lambdarank", "goss"),
    ("rank_xendcg", "masked"), ("rank_xendcg", "goss"),
    ("lambdarank_exact", "masked"), ("lambdarank_position", "masked"),
    ("lambdarank_unbiased", "goss_masked"),
])
def test_ranking_matches_reference(case, path):
    check_parity(case, path)


def test_early_stopping_on_ndcg_at_3():
    """Early stopping on the first metric, ndcg@3 (higher is better):
    the same best iteration, identical trees, the same history."""
    params = {"metric": ["ndcg@3", "map@5"], "first_metric_only": True,
              "early_stopping_round": 2, "learning_rate": 0.5}
    runs, Xv = run_both("lambdarank", "masked", params, rounds=40)
    (ref, ev_r), (port, ev_p) = runs["ref"], runs["port"]
    assert list(ev_p["holdout"]) == list(ev_r["holdout"]) == [
        "ndcg@3", "map@5"]
    rounds = len(ev_r["holdout"]["ndcg@3"])
    assert 1 < ref.best_iteration < rounds < 40        # it did stop early
    assert port.best_iteration == ref.best_iteration
    assert port.current_iteration() == ref.current_iteration() == rounds
    assert tree_split_lines(port.model_to_string()) == tree_split_lines(
        ref.model_to_string())
    for m, hist in ev_r["holdout"].items():
        np.testing.assert_allclose(ev_p["holdout"][m], hist,
                                   rtol=METRIC_RTOL, err_msg=m)
    np.testing.assert_allclose(port.predict(Xv), ref.predict(Xv),
                               rtol=METRIC_RTOL, atol=1e-6)


def test_default_bins_part_only_at_a_near_tie():
    """With the default 4 gradient bins and no stochastic rounding the
    trees part; the first node where they do is a near tie: the split
    each package chose there has, in the other package's tree, a gain
    within 1e-5 of its own."""
    runs, Xv = run_both("lambdarank", "masked", {"num_grad_quant_bins": 4})
    ref, port = runs["ref"][0], runs["port"][0]
    got = tree_split_lines(port.model_to_string())
    want = tree_split_lines(ref.model_to_string())
    part = first_parting_tree(got, want)
    if part is None:
        return
    what, tie = near_tie(port, ref, part)
    assert tie, what
    if part > 0:
        np.testing.assert_allclose(port.predict(Xv, num_iteration=part),
                                   ref.predict(Xv, num_iteration=part),
                                   rtol=METRIC_RTOL, atol=1e-6)


def test_forest_from_jax_on_a_ranking_forest():
    """The reference's lambdarank trees, carried across by
    ``forest_from_jax``, predict in the port's engine what the reference
    predicts (raw scores: ranking has no output transform)."""
    X, y, g, Xv, _, _, _ = rank_data(62)
    params = dict(BASE, **PATHS["masked"][1], objective="lambdarank")
    ref = lgb.Booster(params=dict(params),
                      train_set=lgb.Dataset(X, label=y, group=g))
    eng_r = ref.engine
    fetched = []
    fetch = eng_r._fetch_tree_arrays
    eng_r._fetch_tree_arrays = lambda st: fetched.append(fetch(st)) or \
        fetched[-1]
    for _ in range(3):
        ref.update()
    port = lgt.train(dict(params, device_type="cpu"),
                     lgt.Dataset(X, label=y, group=g), num_boost_round=1)
    eng = port.engine
    eng.models = forest_from_jax(fetched, params["learning_rate"],
                                 eng.train_set.bin_mappers,
                                 eng.train_set.used_features)
    eng._stack_cache = None
    assert len(eng.models) == 3 and eng.init_scores.tolist() == [0.0]
    np.testing.assert_allclose(eng.predict(Xv), ref.predict(Xv), rtol=1e-6,
                               atol=1e-6)
