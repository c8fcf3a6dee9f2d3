"""The port's ranking objectives, metrics and query metadata against the
JAX package's, on the same inputs.

Both packages get the same seeded numpy data: 62 queries of 1 to 60
documents (1,904 rows; one query of one document, one whose relevance is
all zero), relevance 0-4 and scores with ties. Gradients and hessians
agree within rtol 2e-6 of each element or of the array's root mean
square, whichever is larger, as in test_torch_objectives.py: XLA sums a
query's pairs in its own order (the port sums them as a fixed pairwise
tree, ``ranking.tree_sum``, the same on every device), its float32
``log2`` and ``sigmoid`` differ from the port's by ULPs, and 12 of the
first 1,300 entries of its discount table differ from the port's by one
or two ULPs (the port's form, ``ranking.discount_table``, is the one
closest to XLA's that does not depend on the device's ``log``). The position
debiasing state threads three iterations in both, each fed the same
scores. rank_xendcg gets the JAX package's own gammas. Chunking the
queries (``pair_chunk_elems``) changes no bit. The ranking metrics are
host numpy in both and agree within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.config as jcfg
import lightgbm_tpu.metric as jmet
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import capabilities
from lightgbm_tpu_torch import metric as tmet
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.objective import create_objective
from lightgbm_tpu_torch.objective import ranking

RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    test processes at once; see test_torch_regression.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rank_data(seed=0, n_queries=62):
    """(counts, label, score): uneven queries (1 to 60 documents, query 4
    has one, query 7, or the last, is all zero), relevance 0-4, scores
    with ties."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 61, size=n_queries)
    counts[4] = 1
    n = int(counts.sum())
    label = rng.integers(0, 5, size=n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(counts)])
    z = min(7, n_queries - 1)
    label[qb[z]:qb[z + 1]] = 0
    score = rng.normal(size=n).astype(np.float32)
    tied = np.arange(7, n - 1, 7)
    score[tied] = score[tied + 1]
    return counts, label, score


def both(params, counts, label, position=None, weight=None):
    """The JAX package's and the port's objective, prepared on the same
    queries."""
    qb = np.concatenate([[0], np.cumsum(counts)])
    n = len(label)
    ref = jobj.create_objective(jcfg.Config(dict(params)))
    port = create_objective(Config(dict(params)))
    for obj in (ref, port):
        obj.prepare(label, weight)
    ref.setup_queries(qb, n, position=position)
    port.setup_queries(qb, n, position=position, device="cpu")
    return ref, port


def assert_close(got, want, name):
    want = np.asarray(want, np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    err = np.abs(np.asarray(got, np.float64) - want)
    bound = RTOL * np.maximum(np.abs(want), rms)
    assert (err <= bound).all(), (name, float((err / np.maximum(
        np.abs(want), rms)).max()))


def grads_both(ref, port, score, label, weight=None, **kw):
    rkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    out_r = ref.get_gradients(
        jnp.asarray(score), jnp.asarray(label.astype(np.float32)),
        None if weight is None else jnp.asarray(weight.astype(np.float32)),
        **rkw)
    out_p = port.get_gradients(
        torch.from_numpy(score), torch.from_numpy(label.astype(np.float32)),
        None if weight is None
        else torch.from_numpy(weight.astype(np.float32)), **tkw)
    return [np.array(o) for o in out_r], [o.numpy() for o in out_p]


LAMBDARANK = {
    "norm": {},
    "no_norm": {"lambdarank_norm": False},
    "truncation_1": {"lambdarank_truncation_level": 1},
    "truncation_5": {"lambdarank_truncation_level": 5},
    "truncation_30_sigmoid": {"lambdarank_truncation_level": 30,
                              "sigmoid": 1.7},
    "label_gain": {"label_gain": [0.0, 1.0, 2.5, 6.0, 20.0]},
    "weighted": {},
}


@pytest.mark.parametrize("case", list(LAMBDARANK))
def test_lambdarank_gradients_match_reference(case):
    counts, label, score = rank_data()
    weight = (np.random.default_rng(1).uniform(0.2, 3.0, size=len(label))
              if case == "weighted" else None)
    ref, port = both(dict(objective="lambdarank", **LAMBDARANK[case]),
                     counts, label, weight=weight)
    (g_r, h_r), (g_p, h_p) = grads_both(ref, port, score, label, weight)
    assert g_p.dtype == np.float32 and g_p.shape == (len(label),)
    assert_close(g_p, g_r, "grad")
    assert_close(h_p, h_r, "hess")
    assert (h_p >= 0).all() and np.abs(g_p).max() > 0


DEBIAS = {
    "position_field": {},
    "unbiased_p0": {"lambdarank_unbiased": True,
                    "lambdarank_bias_p_norm": 0.0},
    "unbiased_p05": {"lambdarank_unbiased": True,
                     "lambdarank_bias_p_norm": 0.5},
}


@pytest.mark.parametrize("case", list(DEBIAS))
def test_debiased_gradients_match_reference(case):
    """Three iterations with the propensity state threaded in each
    package; both see the same scores (the reference's gradient steps)."""
    counts, label, score = rank_data(seed=2)
    position = (np.random.default_rng(3).integers(0, 12, size=len(label))
                if case == "position_field" else None)
    ref, port = both(dict(objective="lambdarank", **DEBIAS[case]), counts,
                     label, position=position)
    assert ref.has_pos_state and port.has_pos_state
    st_r, st_p = ref.init_pos_state(), port.init_pos_state()
    assert tuple(st_p.shape) == tuple(st_r.shape) == (
        2, 12 if position is not None else int(counts.max()))
    for it in range(3):
        (g_r, h_r, st_r), (g_p, h_p, st_p_np) = grads_both(
            ref, port, score, label, pos_state=np.array(st_r))
        assert_close(g_p, g_r, f"grad, iteration {it}")
        assert_close(h_p, h_r, f"hess, iteration {it}")
        assert_close(st_p_np, st_r, f"propensities, iteration {it}")
        if case == "unbiased_p0":
            assert (st_p_np == 1.0).all()
        else:
            assert not np.allclose(st_p_np, 1.0)
        score = score - 0.5 * np.array(g_r)
    # a position field turns debiasing on without the flag
    assert port.unbiased == (position is not None
                             or DEBIAS[case].get("lambdarank_unbiased"))


def test_bad_bias_p_norm_is_fatal():
    params = {"objective": "lambdarank", "lambdarank_bias_p_norm": -0.5}
    with pytest.raises(lgb.basic.LightGBMError, match="bias_p_norm"):
        jobj.create_objective(jcfg.Config(dict(params)))
    with pytest.raises(lgt.LightGBMError, match="bias_p_norm"):
        create_objective(Config(dict(params)))


@pytest.mark.parametrize("zero_query", [False, True])
def test_xendcg_gradients_match_reference(zero_query):
    """The JAX package's gammas replayed; a query of zero documents (a 0 in
    ``group``) is a row of -inf scores whose softmax is NaN in both; both
    mask it out, so every row stays finite."""
    counts, label, score = rank_data(seed=4)
    if zero_query:
        counts = np.insert(counts, 10, 0)
    ref, port = both({"objective": "rank_xendcg"}, counts, label)
    Q, M = port.query_shape
    assert port.needs_rng and (Q, M) == (len(counts), counts.max())
    for it in range(2):
        key = jax.random.PRNGKey(5 + it)
        gammas = np.array(jax.random.uniform(key, (Q, M)))
        g_r, h_r = [np.array(o) for o in ref.get_gradients(
            jnp.asarray(score), jnp.asarray(label.astype(np.float32)), None,
            key=key)]
        g_p, h_p = [o.numpy() for o in port.get_gradients(
            torch.from_numpy(score), torch.from_numpy(
                label.astype(np.float32)), None,
            gammas=torch.from_numpy(gammas))]
        assert np.isfinite(g_p).all() and np.isfinite(h_p).all()
        assert_close(g_p, g_r, "grad")
        assert_close(h_p, h_r, "hess")
        score = score - g_r


@pytest.mark.parametrize("case", ["norm", "truncation_1", "position_field",
                                  "unbiased_p05", "xendcg"])
def test_chunked_equals_one_batch(case):
    """Queries in chunks of one (and of seven) give the one-batch bits."""
    counts, label, score = rank_data(seed=6)
    params = ({"objective": "rank_xendcg"} if case == "xendcg" else
              dict(objective="lambdarank", **{**LAMBDARANK, **DEBIAS}[case]))
    position = (np.random.default_rng(7).integers(0, 9, size=len(label))
                if case == "position_field" else None)
    _, port = both(params, counts, label, position=position)
    Q, M = port.query_shape
    kw = {}
    if case == "xendcg":
        kw["gammas"] = torch.rand((Q, M), generator=torch.Generator()
                                  .manual_seed(0))
    elif port.has_pos_state:
        kw["pos_state"] = port.init_pos_state()
    args = (torch.from_numpy(score), torch.from_numpy(
        label.astype(np.float32)), None)
    whole = port.get_gradients(*args, **kw)
    T = min(port.truncation, M) if case != "xendcg" else 1
    for per_chunk in (1, 7):
        port.pair_chunk_elems = per_chunk * T * M
        if case != "xendcg":
            assert port.chunk_queries(T, M) == per_chunk
        for a, b in zip(port.get_gradients(*args, **kw), whole):
            assert torch.equal(a, b)


def test_tree_sum_bits_do_not_depend_on_the_batch():
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(9, 30, 61)).astype(np.float32))
    for dim in (1, 2):
        whole = ranking.tree_sum(x, dim)
        for q in range(9):
            assert torch.equal(ranking.tree_sum(x[q:q + 1], dim)[0],
                               whole[q])
    np.testing.assert_allclose(ranking.tree_sum(x, 2).numpy(),
                               x.double().sum(2).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_sort_order_ties_and_padding():
    """``torch.sort(-s, stable=True)`` orders ties by index and the -inf
    padding last, as ``jnp.argsort(-s, stable=True)`` does."""
    s = np.array([[0.5, 1.0, 0.5, -np.inf, 1.0, 0.0, -np.inf],
                  [-np.inf] * 7, [2.0] * 7], dtype=np.float32)
    want = np.array(jax.vmap(lambda r: jnp.argsort(-r, stable=True))(
        jnp.asarray(s)))
    got = torch.sort(-torch.from_numpy(s), dim=1, stable=True).indices
    np.testing.assert_array_equal(got.numpy(), want)


def test_propensity_anchor_is_the_first_positive():
    """``jnp.argmax(c > 0)`` is the first true index, 0 when none is."""
    for c in ([0.0, 0.0, 2.0, 4.0, 0.0], [0.0] * 5, [3.0, 0.0, 1.5, 0.0]):
        c = np.asarray(c, np.float32)
        first = int(torch.argmax(torch.from_numpy(c > 0).to(torch.int32)))
        assert first == int(jnp.argmax(jnp.asarray(c) > 0))
    port = create_objective(Config({"objective": "lambdarank",
                                    "lambdarank_bias_p_norm": 0.5}))
    t = port._propensity(torch.tensor([0.0, 0.0, 2.0, 8.0, 0.0]))
    np.testing.assert_allclose(t.numpy(), [1.0, 1.0, 1.0, 2.0, 1.0])
    assert torch.equal(port._propensity(torch.zeros(4)), torch.ones(4))


def test_discount_table_against_xla():
    M = 1300
    xla = np.array(jax.jit(lambda: 1.0 / jnp.log2(
        jnp.arange(M, dtype=jnp.float32) + 2.0))())
    got = ranking.discount_table(M)
    differ = np.flatnonzero(got != xla)
    assert len(differ) <= 12, differ
    # XLA's float32 log2 is off by up to 2 ULPs there
    assert (np.abs(got.view(np.int32)[differ]
                   - xla.view(np.int32)[differ]) <= 2).all()
    assert differ.min() >= 30          # none inside the default truncation


# ---- metrics ---------------------------------------------------------------
@pytest.mark.parametrize("eval_at", [[1], [3], [10], [1, 3, 10]])
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_ranking_metrics_match_reference(name, eval_at):
    counts, label, score = rank_data(seed=9)
    qb = np.concatenate([[0], np.cumsum(counts)])
    params = {"eval_at": eval_at}
    got = tmet.create_metric(name, Config(params)).eval(
        score.astype(np.float64), label, None, qb)
    want = jmet.create_metric(name, jcfg.Config(params)).eval(
        score.astype(np.float64), label, None, qb)
    assert [n for n, _ in got] == [n for n, _ in want] == [
        f"{name}@{k}" for k in eval_at]
    for (_, a), (_, b) in zip(got, want):
        assert abs(a - b) <= 1e-12 * abs(b), (a, b)


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_ranking_metrics_on_one_document_and_all_zero_queries(name):
    """A 1-document query and an all-zero query alone: ndcg counts both as
    1, map counts the all-zero query as 0, in both packages."""
    label = np.array([2.0, 0.0, 0.0, 0.0])
    score = np.array([0.3, 0.1, 0.5, -0.2])
    qb = np.array([0, 1, 4])
    for eval_at in ([1], [3]):
        got = tmet.create_metric(name, Config({"eval_at": eval_at})).eval(
            score, label, None, qb)
        want = jmet.create_metric(name, jcfg.Config(
            {"eval_at": eval_at})).eval(score, label, None, qb)
        assert got == want
    assert got[0][1] == (1.0 if name == "ndcg" else 0.5)


def test_metric_at_k_names_and_aliases():
    cfg = Config({"objective": "lambdarank",
                  "metric": ["ndcg@3", "map@5", "xendcg"],
                  "ndcg_eval_at": [2, 4]})
    ms = tmet.metrics_for_config(cfg)
    assert [(type(m).__name__, m.config.eval_at) for m in ms] == [
        ("NDCGMetric", [3]), ("MAPMetric", [5]), ("NDCGMetric", [2, 4])]
    [default] = tmet.metrics_for_config(Config({"objective": "rank_xendcg"}))
    assert type(default).__name__ == "NDCGMetric" and default.higher_better
    with pytest.raises(lgt.LightGBMError, match="query"):
        default.eval(np.zeros(3), np.zeros(3), None)


# ---- dataset ---------------------------------------------------------------
def test_group_and_position_fields():
    counts, label, _ = rank_data(seed=10, n_queries=8)
    n = len(label)
    X = np.random.default_rng(11).normal(size=(n, 3))
    pos = np.arange(n) % 5
    ref = lgb.Dataset(X, label=label, group=counts)
    port = lgt.Dataset(X, label=label, group=counts)
    for ds in (ref, port):
        ds.set_field("position", pos)
        ds.construct()
    for f in ("group", "position", "label"):
        np.testing.assert_array_equal(port.get_field(f), ref.get_field(f))
    np.testing.assert_array_equal(port.get_group(), counts)
    assert port.metadata.num_queries() == ref.metadata.num_queries() == 8
    assert port.get_field("position").dtype == np.int32
    v_ref = ref.create_valid(X[:20], label=label[:20], group=[5, 15])
    v_port = port.create_valid(X[:20], label=label[:20], group=[5, 15])
    for v in (v_ref, v_port):
        v.construct()
    np.testing.assert_array_equal(v_port.metadata.query_boundaries,
                                  v_ref.metadata.query_boundaries)
    np.testing.assert_array_equal(v_port.metadata.query_boundaries,
                                  [0, 5, 20])
    port.set_group(None)
    assert port.get_field("group") is None
    with pytest.raises(lgt.LightGBMError, match="Unknown field"):
        port.get_field("nope")


@pytest.mark.parametrize("bad", ["group_sum", "position_length"])
def test_metadata_length_fatals(bad):
    X = np.random.default_rng(12).normal(size=(30, 3))
    y = np.zeros(30)
    for pkg in (lgb, lgt):
        ds = pkg.Dataset(X, label=y, group=[10, 10, 5] if bad == "group_sum"
                         else [10, 20])
        if bad == "position_length":
            ds.set_position(np.arange(29))
        with pytest.raises(Exception, match="Sum of query counts"
                           if bad == "group_sum" else "Length of position"):
            ds.construct()


def test_group_column_is_ignored_for_in_memory_data():
    """``group_column`` belongs to file input: with numpy data both
    packages ignore it, and a ranking objective without ``group`` is
    fatal in both."""
    counts, label, _ = rank_data(seed=13, n_queries=6)
    X = np.random.default_rng(14).normal(size=(len(label), 3))
    X[:, 0] = np.repeat(np.arange(6), counts)
    params = {"objective": "lambdarank", "group_column": 0,
              "verbosity": -1, "num_leaves": 4, "min_data_in_leaf": 1}
    for pkg, extra in ((lgb, {}), (lgt, {"device_type": "cpu"})):
        with pytest.raises(Exception, match="query"):
            pkg.train(dict(params, **extra), pkg.Dataset(X, label=label),
                      num_boost_round=1)
        bst = pkg.train(dict(params, **extra),
                        pkg.Dataset(X, label=label, group=counts),
                        num_boost_round=1)
        assert bst.predict(X).shape == (len(label),)


def test_capabilities_no_longer_refuse_ranking():
    for params in ({"objective": "lambdarank"}, {"objective": "rank_xendcg"},
                   {"objective": "regression", "metric": ["ndcg", "map@3"]},
                   {"objective": "lambdarank", "lambdarank_unbiased": True}):
        assert capabilities.unported_features(Config(params)) == []
    assert capabilities.unported_features(
        Config({"objective": "custom"})) == ["objective"]
