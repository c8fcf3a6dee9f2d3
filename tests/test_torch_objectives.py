"""The port's objectives against the JAX package's, on the same inputs.

Each objective gets the same seeded numpy scores, labels and (or no)
weights in both packages. Gradients and hessians agree within rtol 2e-6 of
each element or of the array's root mean square, whichever is larger:
``torch.exp``, ``sigmoid``, ``softmax`` and ``log1p`` differ from XLA's by
ULPs, and a difference such as ``exp(score) - label`` keeps the ULP of its
terms when it cancels. The boost-from-average init scores, host numpy in
both, agree within 1e-12; ``convert_output`` within the same rtol; the
leaf renewal of L1, quantile and MAPE (host numpy) is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu.config as jcfg
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import objective as tobj
from lightgbm_tpu_torch.config import Config

N, K = 4096, 4
RTOL = 2e-6
# objective name -> extra params
OBJECTIVES = {
    "regression": {},
    "regression_sqrt": {"objective": "regression", "reg_sqrt": True},
    "regression_l1": {},
    "huber": {"alpha": 0.7},
    "fair": {"fair_c": 0.5},
    "poisson": {},
    "quantile": {"alpha": 0.3},
    "mape": {},
    "gamma": {},
    "tweedie": {"tweedie_variance_power": 1.3},
    "multiclass": {"num_class": K},
    "multiclassova": {"num_class": K, "sigmoid": 1.5},
    "cross_entropy": {},
    "cross_entropy_lambda": {},
}
RENEWING = ("regression_l1", "quantile", "mape")


def _params(name):
    return {"objective": name, **OBJECTIVES[name], "verbosity": -1}


def _inputs(name, weighted, seed=0):
    """(score, label, weight) as float32 numpy, shaped for the objective."""
    rng = np.random.default_rng(seed)
    multi = name.startswith("multiclass")
    score = rng.normal(scale=1.5, size=(N, K) if multi else N)
    if multi:
        label = rng.integers(0, K, size=N).astype(np.float64)
    elif name in ("poisson", "tweedie"):
        label = rng.poisson(2.0, size=N).astype(np.float64)
    elif name == "gamma":
        label = rng.gamma(2.0, 1.5, size=N)
    elif name.startswith("cross_entropy"):
        label = rng.uniform(size=N)
    else:
        label = rng.normal(scale=3.0, size=N)
    weight = rng.uniform(0.2, 3.0, size=N) if weighted else None
    f32 = (lambda a: None if a is None else np.asarray(a, np.float32))
    return f32(score), f32(label), f32(weight)


def _pair(name):
    p = _params(name)
    return (jobj.create_objective(jcfg.Config(dict(p))),
            tobj.create_objective(Config(dict(p))))


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    rms = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * rms,
                               err_msg=err_msg)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_gradients_match_reference(name, weighted):
    ref, port = _pair(name)
    score, label, weight = _inputs(name, weighted)
    g_r, h_r = ref.get_gradients(_j(score), _j(label), _j(weight))
    g_p, h_p = port.get_gradients(_t(score), _t(label), _t(weight))
    assert g_p.dtype == h_p.dtype == torch.float32
    assert g_p.shape == score.shape and h_p.shape == score.shape
    _close(g_p.numpy(), g_r, "grad")
    _close(h_p.numpy(), h_r, "hess")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_init_score_matches_reference(name, weighted):
    ref, port = _pair(name)
    _, label, weight = _inputs(name, weighted)
    label = label.astype(np.float64)
    a = port.init_score(label, weight)
    b = ref.init_score(label, weight)
    assert abs(a - b) <= 1e-12 * max(1.0, abs(b))
    stats_p, stats_r = (port.init_mean_stats(label, weight),
                        ref.init_mean_stats(label, weight))
    assert (stats_p is None) == (stats_r is None)
    if stats_p is not None:
        np.testing.assert_allclose(stats_p, stats_r, rtol=1e-12)
        mean = stats_p[0] / stats_p[1]
        assert abs(port.init_from_mean(mean) - ref.init_from_mean(mean)) \
            <= 1e-12 * max(1.0, abs(ref.init_from_mean(mean)))


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_convert_output_matches_reference(name):
    ref, port = _pair(name)
    score, _, _ = _inputs(name, False)
    _close(port.convert_output(_t(score)).numpy(),
           ref.convert_output(_j(score)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", RENEWING)
def test_renew_tree_output_equals_reference(name, weighted):
    ref, port = _pair(name)
    assert port.renews and not tobj.create_objective(
        Config({"objective": "huber"})).renews
    score, label, weight = _inputs(name, weighted)
    rng = np.random.default_rng(1)
    leaf_id = rng.integers(0, 13, size=N).astype(np.int32)
    leaf_id[leaf_id == 5] = 6                      # a leaf with no rows
    a = port.renew_tree_output(score, label, weight, leaf_id, 15)
    b = ref.renew_tree_output(score, label, weight, leaf_id, 15)
    np.testing.assert_array_equal(a, b)
    assert a[5] == 0.0 and a[13] == 0.0


def test_registry_matches_reference():
    assert set(tobj._REGISTRY) == set(jobj._REGISTRY) - {"custom"}
    for name, cls in tobj._REGISTRY.items():
        assert cls.name == jobj._REGISTRY[name].name
        p = {"objective": name, "num_class": 3}
        assert (Config(p).num_tree_per_iteration
                == jobj._REGISTRY[name](jcfg.Config(p)).num_models(3))


@pytest.mark.parametrize("params,named", [
    ({"objective": "custom"}, "custom"),
])
def test_ranking_stays_refused(params, named):
    """The ranking objectives and metrics train now
    (tests/test_torch_ranking*.py); the custom objective stays refused."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 3))
    with pytest.raises(lgt.LightGBMError, match=named):
        lgt.train(dict(params, device_type="cpu", verbosity=-1),
                  lgt.Dataset(X, label=(X[:, 0] > 0).astype(float)),
                  num_boost_round=1)


def _xla_inputs():
    """10^6 float32 inputs: normal draws at scales 0.5, 2 and 6, a dense
    grid over [-100, 100] and the edges."""
    rng = np.random.default_rng(0)
    draws = np.concatenate([rng.normal(size=200_000) * s
                            for s in (0.5, 2.0, 6.0)])
    edges = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45,
                      1e-40, -1e-40, 1.17e-38, -87.8, 87.8, 88.8, -88.8,
                      88.7, 88.72, 88.723, 88.73, -87.33, -87.34, -103.9,
                      -104.0, 104.0, 3.4e38, -3.4e38])
    grid = np.linspace(-100.0, 100.0, 400_000 - len(edges))
    return np.concatenate([draws, grid, edges]).astype(np.float32)


def test_xla_exp_and_sigmoid_give_jax_bits():
    x = _xla_inputs()
    assert x.size == 1_000_000
    for port, ref in ((tobj._exp_xla, jnp.exp),
                      (tobj._sigmoid_xla, jax.nn.sigmoid)):
        want = np.asarray(jax.jit(ref)(x))
        got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # the edges as XLA handles them
    e = tobj._exp_xla(torch.tensor([np.inf, -np.inf, 88.73, -87.34, 0.0,
                                    np.nan], dtype=torch.float32))
    assert e[0] == np.inf and e[1] == 0.0 and e[2] == np.inf
    assert e[3] == 0.0 and e[4] == 1.0 and torch.isnan(e[5])


BIT_EXACT = {
    "binary": {"objective": "binary"},
    "binary_weighted_sigmoid": {"objective": "binary", "sigmoid": 1.5,
                                "scale_pos_weight": 2.0},
    "poisson": {"objective": "poisson"},
    "gamma": {"objective": "gamma"},
    "cross_entropy": {"objective": "cross_entropy"},
    "multiclassova": {"objective": "multiclassova", "num_class": K,
                      "sigmoid": 1.5},
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(BIT_EXACT))
def test_exp_sigmoid_gradients_bit_equal(case, weighted):
    p = dict(BIT_EXACT[case], verbosity=-1)
    ref = jobj.create_objective(jcfg.Config(dict(p)))
    port = tobj.create_objective(Config(dict(p)))
    name = p["objective"]
    if name == "binary":
        rng = np.random.default_rng(0)
        score = rng.normal(scale=1.5, size=N).astype(np.float32)
        label = (rng.random(N) < 0.4).astype(np.float32)
        weight = (rng.uniform(0.2, 3.0, size=N).astype(np.float32)
                  if weighted else None)
        if hasattr(ref, "prepare"):
            ref.prepare(label, weight)
            port.prepare(label, weight)
    else:
        score, label, weight = _inputs(name, weighted)
    g_r, h_r = ref.get_gradients(_j(score), _j(label), _j(weight))
    g_p, h_p = port.get_gradients(_t(score), _t(label), _t(weight))
    for got, want in ((g_p, g_r), (h_p, h_r)):
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    if name == "binary":
        g_j, h_j = jax.jit(ref.get_gradients)(_j(score), _j(label),
                                              _j(weight))
        np.testing.assert_array_equal(g_p.numpy(), np.asarray(g_j))
        np.testing.assert_array_equal(h_p.numpy(), np.asarray(h_j))
