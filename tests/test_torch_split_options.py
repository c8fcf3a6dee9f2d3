"""Port parity: the split search's options, op by op and tree by tree.

The JAX package's split search and ``grow_tree`` (jitted, on the CPU, as
its own tests run them) and the port's get the same numpy-seeded inputs:

- ``find_best_split`` / ``per_feature_gains`` with ``extra_trees``'
  uniforms, ``feature_contri``'s factors and CEGB's penalties (numerical
  and categorical): every output bit-equal. With ``path_smooth`` the
  winners are the same and the gains agree within ``GAIN_RTOL``: XLA
  contracts one product of each smoothed output into an FMA, which one
  depending on the fusion (the port reproduces the split search's own
  argmax evaluation, ``smooth_output``'s ``fused``; the read-back of the
  winner's gain fuses otherwise);
- ``bynode_mask`` on the reference's uniforms, ``k`` rounded up in float32
  (``0.1 * 30`` is 3 there and 4 in float64), the lazy penalty's row
  counts and the acquisition fold against the reference's bf16 products;
- ``grow_tree`` on identical bins and integer gradient levels with a
  power-of-two scale (every sum exact), the draws replayed from the
  reference's node key: each option, and bynode with interaction
  constraints, CEGB coupled and lazy (``leaf_used`` included) and forced
  splits, at leaf batch 1 and 8, masked, on the compacted buffer and under
  the partition: every tree array bit-equal. ``path_smooth`` keeps the
  split lines and rows (every integer array), its float arrays within
  ``LEAF_RTOL`` of the tree's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.boosting.gbdt import _cegb_u_fold
from lightgbm_tpu.learner.serial import GrowConfig as JaxGrowConfig
from lightgbm_tpu.learner.serial import grow_tree as jax_grow_tree
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.learner import serial as tserial
from lightgbm_tpu_torch.ops import split as ts
from test_torch_grow import POW2_SCALE, _data
from test_torch_regression import _one_torch_thread  # noqa
from test_torch_split import _hists

GAIN_RTOL = 2e-5
LEAF_RTOL = 2e-5
INT_KEYS = ("num_leaves", "split_feature", "threshold_bin", "default_left",
            "left_child", "right_child", "internal_count", "leaf_count")
t = torch.from_numpy

# ---------------------------------------------------------------------------
# the split search
# ---------------------------------------------------------------------------
SEARCH_OPTS = {
    "extra_trees": dict(extra_trees=True),
    "contri": dict(has_contri=True),
    "cegb": dict(has_cegb=True, cegb_penalty_split=0.01, cegb_tradeoff=0.7),
    "cegb_split_only": dict(has_cegb=True, cegb_penalty_split=0.02),
    "all_but_smooth": dict(extra_trees=True, has_contri=True, has_cegb=True,
                           cegb_penalty_split=0.02),
    "smooth": dict(path_smooth=500.0),
    "smooth_all": dict(path_smooth=3.0, extra_trees=True, has_contri=True,
                       has_cegb=True, cegb_penalty_split=0.02),
}


def _search_inputs(C=16, F=12, B=64, seed=5):
    hist, sums, nb, hn, allowed = _hists(C, F, B, seed=seed)
    rng = np.random.default_rng(seed + 1)
    is_cat = np.zeros(F, bool)
    is_cat[[2, 7]] = True
    return dict(hist=hist, sums=sums, nb=nb, hn=hn & ~is_cat,
                allowed=allowed, is_cat=is_cat,
                parent_out=(rng.normal(size=C) * 0.3).astype(np.float32),
                extra_u=rng.random((C, F)).astype(np.float32),
                contri=rng.uniform(0.3, 1.5, F).astype(np.float32),
                cegb_pen=(rng.random((C, F)) * 300).astype(np.float32))


def _both_searches(opts, categorical, fn="find_best_split"):
    d = _search_inputs()
    kw = dict(min_data_in_leaf=5, lambda_l2=0.5,
              has_categorical=categorical, max_cat_to_onehot=4,
              min_data_per_group=5, **opts)
    pos = tuple(int(i) for i in np.flatnonzero(d["is_cat"]))
    jcfg = js.SplitConfig(**kw, cat_positions=pos if categorical else ())
    tcfg = ts.SplitConfig(**kw)
    nb, hn, ic = (jnp.asarray(d[k]) for k in ("nb", "hn", "is_cat"))
    contri = jnp.asarray(d["contri"])

    def one(h, s, a, p, e, cp):
        return getattr(js, fn)(h, s, nb, hn, a, jcfg, is_cat=ic, cegb_pen=cp,
                               parent_out=p, extra_u=e, contri=contri)
    ref = jax.jit(jax.vmap(one))(*(jnp.asarray(d[k]) for k in (
        "hist", "sums", "allowed", "parent_out", "extra_u", "cegb_pen")))
    out = getattr(ts, fn)(
        t(d["hist"]), t(d["sums"]), t(d["nb"]), t(d["hn"]), t(d["allowed"]),
        tcfg, is_cat=t(d["is_cat"]) if categorical else None,
        cat_idx=t(np.flatnonzero(d["is_cat"])) if categorical else None,
        cegb_pen=t(d["cegb_pen"]), parent_out=t(d["parent_out"]),
        extra_u=t(d["extra_u"]), contri=t(d["contri"]))
    return ref, out


def _assert_gains_close(got, want):
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=GAIN_RTOL, atol=0)


@pytest.mark.parametrize("categorical", [False, True])
@pytest.mark.parametrize("opt", list(SEARCH_OPTS))
def test_find_best_split_options_match(opt, categorical):
    ref, out = _both_searches(SEARCH_OPTS[opt], categorical)
    assert set(out) <= set(ref)
    smooth = "path_smooth" in SEARCH_OPTS[opt]
    assert np.isfinite(out["gain"].numpy()).sum() >= 8
    for k, v in out.items():
        a, b = np.asarray(ref[k]), v.numpy()
        if k == "cat_bitset":
            a = a.astype(np.int64)
        if k == "gain" and smooth:
            _assert_gains_close(b, a)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("categorical", [False, True])
@pytest.mark.parametrize("opt", ["cegb", "all_but_smooth", "smooth_all"])
def test_per_feature_gains_options_bit_equal(opt, categorical):
    ref, out = _both_searches(SEARCH_OPTS[opt], categorical,
                              fn="per_feature_gains")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_options_change_the_winners():
    """Each option moves some winner, so the equalities above bite."""
    d = _search_inputs()
    plain = ts.find_best_split(t(d["hist"]), t(d["sums"]), t(d["nb"]),
                               t(d["hn"]), t(d["allowed"]),
                               ts.SplitConfig(min_data_in_leaf=5,
                                              lambda_l2=0.5))
    for opt in ("extra_trees", "contri", "cegb", "smooth"):
        _, out = _both_searches(SEARCH_OPTS[opt], False)
        moved = ((out["feature"] != plain["feature"])
                 | (out["threshold_bin"] != plain["threshold_bin"]))
        assert moved.any(), opt


def test_smooth_output_bit_equal():
    rng = np.random.default_rng(2)
    raw = (rng.normal(size=4096) * 3).astype(np.float32)
    cnt = rng.integers(0, 500, size=4096).astype(np.float32)
    par = (rng.normal(size=4096)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda r, c, p: js.smooth_output(r, c, p, 7.0))(
        raw, cnt, par))
    out = ts.smooth_output(t(raw), t(cnt), t(par), 7.0).numpy()
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# bynode, the lazy penalty and the acquisition fold
# ---------------------------------------------------------------------------
def _reference_bynode(allow2, u, frac):
    """``learner/serial.py::bynode_mask`` of the JAX package on given
    uniforms (its closure, with the draw taken out)."""
    F = allow2.shape[1]
    uu = jnp.where(allow2, u, jnp.inf)
    n_allow = jnp.sum(allow2, axis=1)
    k_idx = jnp.clip(jnp.ceil(frac * n_allow.astype(jnp.float32))
                     .astype(jnp.int32) - 1, 0, F - 1)
    kth = jnp.take_along_axis(jnp.sort(uu, axis=1), k_idx[:, None], axis=1)
    return allow2 & (uu <= kth)


@pytest.mark.parametrize("frac,F", [(0.5, 28), (0.1, 30), (0.7, 9),
                                    (0.35, 40)])
def test_bynode_mask_matches_reference(frac, F):
    rng = np.random.default_rng(F)
    allow = rng.random((64, F)) < 0.8
    allow[0] = True
    allow[1] = False
    u = np.array(jax.random.uniform(jax.random.PRNGKey(F), (64, F)))
    ref = np.asarray(jax.jit(lambda a, uu: _reference_bynode(a, uu, frac))(
        allow, u))
    out = tserial.bynode_mask(t(allow), t(u), frac).numpy()
    np.testing.assert_array_equal(out, ref)
    # exact k of the allowed features, rounded up in float32
    k = np.ceil(np.float32(frac) * allow.sum(1).astype(np.float32))
    np.testing.assert_array_equal(out.sum(1), np.where(allow.any(1), k, 0))


def test_bynode_k_rounds_in_float32():
    # 0.1 * 30 = 3.0000000000000004 in float64, 3 in float32
    allow = torch.ones((1, 30), dtype=torch.bool)
    u = torch.rand((1, 30), generator=torch.Generator().manual_seed(0))
    assert int(tserial.bynode_mask(allow, u, 0.1).sum()) == 3


def test_lazy_counts_match_reference_product():
    rng = np.random.default_rng(3)
    n, F, L = 5000, 9, 15
    leaf = rng.integers(0, L, size=n).astype(np.int32)
    U = rng.random((n, F)) < 0.4
    ids = np.array([0, 3, 7, 14, L, 2], np.int32)
    notU = (1.0 - jnp.asarray(U).astype(jnp.float32)).astype(jnp.bfloat16)
    mk = (jnp.asarray(leaf)[:, None]
          == jnp.asarray(ids)[None, :]).astype(jnp.bfloat16)
    ref = np.asarray(jax.lax.dot_general(
        mk, notU, dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))
    out = tserial.lazy_counts(t(leaf), t((~U).astype(np.float32)),
                              L + 1)[t(ids).long()].numpy()
    np.testing.assert_array_equal(out, ref)


def test_acquisition_fold_matches_reference():
    rng = np.random.default_rng(4)
    n, F, L = 3000, 7, 15
    U = rng.random((n, F)) < 0.2
    used = rng.random((L, F)) < 0.3
    leaf = rng.integers(0, L, size=n).astype(np.int32)
    ins = rng.random(n) < 0.6
    ref = np.asarray(_cegb_u_fold(jnp.asarray(U), jnp.asarray(used),
                                  jnp.asarray(leaf), jnp.asarray(ins)))
    out = tserial.acquire(t(U), t(used), t(leaf), t(ins)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out & ~U).any() and not (out[~ins] != U[~ins]).any()


@pytest.mark.parametrize("n", [2048, 8192, 20_480])
def test_exact_root_sums_take_xla_order(n):
    """On float32 values the root's sums are added in the order of the
    reference's ``jnp.sum`` (``sum_bins``), the same bits on the card and
    the CPU: the root node's output and weight equal the reference's."""
    rng = np.random.default_rng(n)
    bins, _, nb, hn = _data(n=n, B=64, seed=3)
    vals = np.stack([rng.normal(size=n), rng.uniform(0.05, 0.25, size=n),
                     np.ones(n)], 1).astype(np.float32)
    F = bins.shape[1]
    kw = dict(num_leaves=4, num_bins=64, min_data_in_leaf=5)
    jt, _ = jax_grow_tree(jnp.asarray(bins), jnp.asarray(vals),
                          jnp.asarray(nb), jnp.asarray(hn),
                          jnp.ones(F, bool),
                          JaxGrowConfig(rows_per_block=1024, **kw))
    tt, _ = tserial.grow_tree(t(bins.T.copy()), t(vals), t(nb), t(hn),
                              torch.ones(F, dtype=torch.bool),
                              tserial.GrowConfig(**kw))
    for k in ("internal_value", "internal_count"):
        np.testing.assert_array_equal(tt[k].numpy()[0], np.asarray(jt[k])[0],
                                      err_msg=k)
    want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=0))(vals))
    got = tserial.sum_bins(t(vals).T[None])[0].numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# grow_tree
# ---------------------------------------------------------------------------
def _table(rows, W=2):
    """A preorder forced-split table from (parent, is_left, feature,
    threshold bin) rows."""
    par, il, fe, tb = zip(*rows)
    return (np.array(par, np.int32), np.array(il, bool),
            np.array(fe, np.int32), np.array(tb, np.int32),
            np.zeros(len(rows), bool), np.zeros((len(rows), W), np.uint32))


FORCED = _table([(-1, False, 0, 10), (0, True, 1, 5), (1, True, 0, 3),
                 (0, False, 2, 20)])
# entry 1 sends every row left (bin 63): it and its child are skipped and
# free growth fills the tree
FORCED_SKIP = _table([(-1, False, 0, 10), (0, True, 1, 63), (1, True, 0, 3),
                      (0, False, 2, 20)])

TREE_OPTS = {
    "bynode": dict(feature_fraction_bynode=0.5),
    "extra_trees": dict(extra_trees=True),
    "contri": dict(has_contri=True),
    "interaction": dict(has_interaction=True),
    "bynode_interaction": dict(has_interaction=True,
                               feature_fraction_bynode=0.6),
    "cegb_coupled": dict(has_cegb=True, cegb_penalty_split=1e-5),
    "cegb_lazy": dict(has_cegb=True, has_cegb_lazy=True,
                      cegb_penalty_split=1e-6),
    "forced": dict(n_forced=4),
    "forced_skip": dict(n_forced=4),
    "forced_depth": dict(n_forced=4, max_depth=2),
    "smooth": dict(path_smooth=20.0),
}


def _grow_both(name, leaf_batch, path):
    opts = TREE_OPTS[name]
    bins, vals, nb, hn = _data(B=64, seed=8)
    n, F = bins.shape
    allowed = np.ones(F, bool)
    allowed[3] = False
    compact, partition = path == "compact", path == "partition"
    common = dict(num_leaves=31, num_bins=64, leaf_batch=leaf_batch,
                  hist_compact=compact, min_data_in_leaf=5,
                  partition=partition, **opts)
    jcfg = JaxGrowConfig(rows_per_block=1024, **common)
    tcfg = tserial.GrowConfig(int_hist=True, **common)
    node_key = jax.random.fold_in(jax.random.PRNGKey(11), 3)
    j = dict(chan_scale=jnp.asarray(POW2_SCALE), node_key=node_key)
    tk = dict(chan_scale=t(POW2_SCALE))
    rng = np.random.default_rng(5)
    if opts.get("has_interaction"):
        g = np.zeros((3, F), bool)
        g[0, [0, 1, 2, 5]] = g[1, [2, 3, 4, 6, 7]] = True
        g[2, [8, 9, 10, 11, 1]] = True
        j["groups"], tk["groups"] = jnp.asarray(g), t(g)
    if opts.get("has_contri"):
        c = rng.uniform(0.5, 1.5, F).astype(np.float32)
        j["contri"], tk["contri"] = jnp.asarray(c), t(c)
    if opts.get("has_cegb"):
        c = (rng.random(F) * 0.02).astype(np.float32)
        c[::3] = 0
        j["cegb_pen"], tk["cegb_pen"] = jnp.asarray(c), t(c)
    if opts.get("has_cegb_lazy"):
        U = rng.random((n, F)) < 0.3
        pen = (rng.random(F) * 1e-5).astype(np.float32)
        j["lazy"], tk["lazy"] = (jnp.asarray(U), jnp.asarray(pen)), (t(U),
                                                                     t(pen))
    if name.startswith("forced"):
        table = FORCED_SKIP if name == "forced_skip" else FORCED
        j["forced"] = tuple(jnp.asarray(a) for a in table)
        tk["forced"] = tserial.ForcedSplits(
            *table[:5], table[5].astype(np.int64))

    def draws(key):
        def f(tag, C):
            return t(np.array(jax.random.uniform(jax.random.fold_in(key, tag),
                                                 (C, F))))
        return f
    tk["node_draws"] = draws(node_key)
    tk["extra_draws"] = draws(jax.random.fold_in(node_key, 0xE77A + 6))
    hv = vals
    if compact:
        idx = np.sort(np.random.default_rng(7).choice(n, 4096,
                                                      replace=False))
        hv = vals[idx]
        j["compact"] = (jnp.asarray(bins[idx]), None, jnp.asarray(hv))
        tk["compact_bins_t"] = t(bins[idx].T.copy())
    jt, jl = jax_grow_tree(jnp.asarray(bins), jnp.asarray(hv),
                           jnp.asarray(nb), jnp.asarray(hn),
                           jnp.asarray(allowed), jcfg, **j)
    tt, tl = tserial.grow_tree(t(bins.T.copy()), t(hv), t(nb), t(hn),
                               t(allowed), tcfg, **tk)
    return ({k: np.asarray(v) for k, v in jt.items()}, np.asarray(jl),
            {k: np.asarray(v) for k, v in tt.items()}, tl.numpy())


# every option masked at leaf batch 8; the compacted buffer and the
# partition for the options that touch the row passes or the counts; leaf
# batch 1 for the per-round state
TREE_CASES = ([(name, 8, "masked") for name in TREE_OPTS]
              + [(name, 8, path) for name in ("bynode_interaction",
                                              "cegb_lazy", "forced", "smooth")
                 for path in ("compact", "partition")]
              + [(name, 1, "masked") for name in ("forced", "forced_skip",
                                                  "cegb_lazy",
                                                  "cegb_coupled")])


@pytest.mark.parametrize("name,leaf_batch,path", TREE_CASES)
def test_grow_tree_options_match(name, leaf_batch, path):
    jt, jl, tt, tl = _grow_both(name, leaf_batch, path)
    assert set(tt) == set(jt)
    nl = int(tt["num_leaves"])
    assert nl == (4 if name == "forced_depth" else 31)
    np.testing.assert_array_equal(tl, jl)
    for k, v in tt.items():
        assert v.dtype == jt[k].dtype, k
        if name == "smooth" and k not in INT_KEYS and k != "hist_rows":
            scale = np.abs(jt[k]).max()
            np.testing.assert_allclose(v, jt[k], rtol=0,
                                       atol=LEAF_RTOL * scale, err_msg=k)
        else:
            np.testing.assert_array_equal(v, jt[k], err_msg=k)
    if name.startswith("forced"):
        # the forced lines head the tree: feature 0 at bin 10 at the root
        assert (tt["split_feature"][0], tt["threshold_bin"][0]) == (0, 10)
        if name == "forced":
            assert sorted(tt["split_feature"][1:4]) == [0, 1, 2]
        if name == "forced_skip":
            # the skipped entry's leaf split freely
            assert tt["split_feature"][1] == 2
    if name == "cegb_lazy":
        assert tt["leaf_used"].shape == (31, 12)
        assert tt["leaf_used"].any(axis=1).all()
