"""Port parity: the leaf-ordered row partition (tpu_hist_partition).

The port's ``ops/partition.py`` against the JAX package's on the same
seeded inputs: the move plan and table updates bit-equal over several
random split batches (with the layout invariants of
tests/test_partition.py), the span ladder and span slicing equal, the
one-call move ``partition_move`` equal to the JAX plan plus
``move_rows_xla`` (its prefix output feeding the JAX tables). Then
``grow_tree(partition=True)`` of both packages bit-equal (tree arrays,
leaf ids, ``hist_rows``) under
power-of-two channel scales, and the port's engine writing byte-equal
model text with the partition on and off under quantized gradients.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import partition as jax_part
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.ops import partition as part
from test_torch_grow import POW2_SCALE, _grow_both
from test_torch_regression import _one_torch_thread  # noqa

_GROWN = {}


def _grown(leaf_batch, compact, partition=False):
    """``_grow_both`` at the power-of-two scale, run once per arguments in
    this module (the tests only read its arrays)."""
    key = (leaf_batch, compact, partition)
    if key not in _GROWN:
        _GROWN[key] = _grow_both(leaf_batch, compact, POW2_SCALE,
                                 partition=partition)
    return _GROWN[key]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- move plan + tables ----------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plan_and_tables_bit_equal_and_invariants(seed):
    """Over random split batches: dest, n_front, cum and the new tables
    equal the JAX functions'; dest is a permutation; every leaf's rows
    are contiguous at its table offset, counts sum to n, and within-leaf
    source order is kept."""
    rng = np.random.default_rng(seed)
    n, L, Kb = 777, 31, 4
    leaf = np.zeros(n, np.int32)
    off = np.zeros(L + 1, np.int32)
    cnt = np.zeros(L + 1, np.int32)
    cnt[0] = n
    tag = np.arange(n)
    num_leaves = 1
    for _ in range(6):
        active = [lf for lf in range(num_leaves) if cnt[lf] > 1]
        k = min(Kb, len(active), L - 1 - num_leaves)
        if k <= 0:
            break
        parents = np.full(Kb, L, np.int32)       # invalid lanes -> trash
        new_ids = np.full(Kb, L, np.int32)
        parents[:k] = rng.choice(active, size=k, replace=False)
        new_ids[:k] = np.arange(num_leaves, num_leaves + k)
        valid = np.arange(Kb) < k
        new_leaf = leaf.copy()
        for p, nid in zip(parents[:k], new_ids[:k]):
            rows = np.flatnonzero(leaf == p)
            new_leaf[rows[rng.random(len(rows)) < rng.uniform(0.1, 0.9)]] \
                = nid
        moved = new_leaf != leaf
        d_t, nf_t, cum_t = part.plan_split_move(_t(moved))
        d_j, nf_j, cum_j = jax_part.plan_split_move(jnp.asarray(moved))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(cum_t.numpy(), np.asarray(cum_j))
        assert int(nf_t) == int(nf_j) == int((~moved).sum())
        assert d_t.dtype == torch.int32
        dest = d_t.numpy()
        assert sorted(dest.tolist()) == list(range(n))
        off_t, cnt_t = part.update_tables(
            _t(off), _t(cnt), cum_t, nf_t, _t(parents).long(),
            _t(new_ids).long(), _t(valid))
        off_j, cnt_j = jax_part.update_tables(
            jnp.asarray(off), jnp.asarray(cnt), cum_j, nf_j,
            jnp.asarray(parents), jnp.asarray(new_ids), jnp.asarray(valid))
        np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        off, cnt = off_t.numpy().copy(), cnt_t.numpy().copy()
        order = np.empty(n, np.int64)
        order[dest] = np.arange(n)
        leaf = new_leaf[order]
        tag = tag[order]
        num_leaves += k
        assert int(cnt[:num_leaves].sum()) == n
        for lf in range(num_leaves):
            rows = np.flatnonzero(leaf == lf)
            assert len(rows) == cnt[lf]
            if len(rows):
                assert rows[0] == off[lf]
                assert rows[-1] == off[lf] + cnt[lf] - 1
                assert np.all(np.diff(tag[rows]) > 0)


@pytest.mark.parametrize("n", [1024, 4096, 100_000, 2_002_944])
@pytest.mark.parametrize("m", [1, 8, 32])
def test_span_budgets_equal(n, m):
    budgets = part.span_budgets(n, m)
    assert budgets == jax_part.span_budgets(n, m)
    assert all(m * s < n for s in budgets)


@pytest.mark.parametrize("budget", [16, 32, 64])
def test_slice_spans_equal(budget):
    """Windows clamped into range, neighbours' rows masked to -1: the
    port's feature-major slices equal the JAX package's."""
    n, F, C = 64, 3, 2
    rng = np.random.default_rng(7)
    bins = rng.integers(0, 8, size=(F, n)).astype(np.uint8)
    vals = rng.normal(size=(C, n)).astype(np.float32)
    leaf = np.repeat(np.asarray([0, 1, 2, 3], np.int32), 16)
    offs = np.asarray([16, 48, 0], np.int32)      # leaves 1, 3, 0
    cnts = np.asarray([16, 16, 0], np.int32)      # lane 2 inactive
    got = part.slice_spans(_t(bins), _t(vals), _t(leaf), _t(offs),
                           _t(cnts), budget)
    want = jax_part.slice_spans(jnp.asarray(bins), jnp.asarray(vals),
                                jnp.asarray(leaf), jnp.asarray(offs),
                                jnp.asarray(cnts), budget, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32
    if budget == 32:
        ls = got[2].numpy()
        np.testing.assert_array_equal(ls[:16], 1)
        np.testing.assert_array_equal(ls[16:32], -1)
        np.testing.assert_array_equal(ls[32:48], -1)  # clamped to start 32
        np.testing.assert_array_equal(ls[48:64], 3)
        np.testing.assert_array_equal(ls[64:], -1)


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_move_cols_cpu_equals_move_rows_xla(frac):
    """``partition_move`` on the CPU: the columns moved as the JAX plan
    (``plan_split_move(leaf_new != leaf_old)``) and ``move_rows_xla``
    move them, ``n_front`` and ``cum`` equal, and the tables updated from
    its prefix output equal the JAX ``update_tables``."""
    rng = np.random.default_rng(int(frac * 10))
    n, F, C, L = 1001, 5, 3, 31
    bins = rng.integers(0, 256, size=(F, n)).astype(np.uint8)
    vals = rng.normal(size=(C, n)).astype(np.float32)
    # three leaves in spans; every row of a moved leaf's right part changes
    # its id (the shape of one split batch)
    old = np.repeat(np.asarray([0, 1, 2], np.int32), [400, 351, 250])
    new = old.copy()
    moved = rng.random(n) < frac
    new[moved & (old == 0)] = 3
    new[moved & (old == 2)] = 4
    moved = new != old
    before = part.partition_move.launches
    (ob, ov, ol), nf, cum = part.partition_move(_t(bins), _t(vals), _t(old),
                                                _t(new))
    assert part.partition_move.launches == before      # CPU: no kernel
    d, nf_j, cum_j = jax_part.plan_split_move(jnp.asarray(moved))
    jb, jv = jax_part.move_rows_xla([jnp.asarray(bins), jnp.asarray(vals)],
                                    d, axis=1)
    [jl] = jax_part.move_rows_xla([jnp.asarray(new)], d)
    np.testing.assert_array_equal(ob.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ov.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(ol.numpy(), np.asarray(jl))
    assert nf.dtype == torch.int32 and cum.dtype == torch.int32
    assert int(nf) == int(nf_j) == int((~moved).sum())
    np.testing.assert_array_equal(cum.numpy(), np.asarray(cum_j))
    off = np.zeros(L + 1, np.int32)
    cnt = np.zeros(L + 1, np.int32)
    off[:3], cnt[:3] = [0, 400, 751], [400, 351, 250]
    parents = np.asarray([0, 2, L, L], np.int32)
    new_ids = np.asarray([3, 4, L, L], np.int32)
    valid = np.asarray([True, True, False, False])
    off_t, cnt_t = part.update_tables(_t(off), _t(cnt), cum, nf,
                                      _t(parents).long(), _t(new_ids).long(),
                                      _t(valid))
    off_j, cnt_j = jax_part.update_tables(
        jnp.asarray(off), jnp.asarray(cnt), cum_j, nf_j,
        jnp.asarray(parents), jnp.asarray(new_ids), jnp.asarray(valid))
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    # into a given buffer; never in place
    bufs = tuple(torch.empty_like(t) for t in (ob, ov, ol))
    again, _, _ = part.partition_move(_t(bins), _t(vals), _t(old), _t(new),
                                      out=bufs)
    assert all(a is b for a, b in zip(again, bufs))
    src = _t(bins)
    with pytest.raises(ValueError, match="in place"):
        part.partition_move(src, _t(vals), _t(old), _t(new),
                            out=(src, bufs[1], bufs[2]))


# ---- grow_tree -------------------------------------------------------------
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("leaf_batch", [1, 8])
def test_grow_tree_partition_bit_equal(leaf_batch, compact):
    jt, jl, tt, tl = _grown(leaf_batch, compact, partition=True)
    assert int(tt["num_leaves"]) > 20
    assert set(tt) == set(jt)
    for k, v in tt.items():
        assert v.dtype == jt[k].dtype, k
        np.testing.assert_array_equal(v, jt[k], err_msg=k)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("leaf_batch", [1, 8])
def test_grow_tree_partition_scans_fewer_rows(leaf_batch, compact):
    """Same tree as the masked scan, fewer rows scanned; the masked
    count is the source's rows x (rounds + 1)."""
    _, _, masked, ml = _grown(leaf_batch, compact)
    _, _, parted, pl = _grown(leaf_batch, compact, partition=True)
    for k in masked:
        if k != "hist_rows":
            np.testing.assert_array_equal(parted[k], masked[k], err_msg=k)
    np.testing.assert_array_equal(pl, ml)
    n_h = 4096 if compact else 8192
    rounds = masked["hist_rows"] / n_h - 1
    assert rounds == int(rounds) and rounds >= 30 // leaf_batch
    assert parted["hist_rows"] < masked["hist_rows"]


# ---- engine ----------------------------------------------------------------
def _engine_data(n=4000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X @ rng.normal(size=f)
         + rng.normal(scale=0.3, size=n) > 0).astype(np.float64)
    return X, y


def _train(X, y, extra, rounds=6):
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "learning_rate": 0.3, "device_type": "cpu"}
    params.update(extra)
    return lgt.train(params, lgt.Dataset(X, label=y), num_boost_round=rounds)


QUANT_MATRIX = [
    ("full_row", {"use_quantized_grad": True}),
    ("bagging", {"use_quantized_grad": True, "bagging_fraction": 0.7,
                 "bagging_freq": 1, "feature_fraction": 0.8}),
    ("goss", {"data_sample_strategy": "goss", "top_rate": 0.3,
              "other_rate": 0.2, "use_quantized_grad": True,
              "tpu_goss_compact": False}),
    ("goss_compact", {"data_sample_strategy": "goss", "top_rate": 0.2,
                      "other_rate": 0.1, "use_quantized_grad": True,
                      "tpu_goss_compact": True}),
]
# rows per case: the compacted buffer (sampled rows + 8192 of slack)
# must be narrower than the data for tpu_goss_compact to engage
N_ROWS = {"goss_compact": 24_000}


@pytest.mark.parametrize("name,extra", QUANT_MATRIX,
                         ids=[m[0] for m in QUANT_MATRIX])
def test_engine_model_text_equal_quantized(name, extra):
    """Integer histogram sums are order-free, so the partitioned engine
    writes the masked engine's model text byte for byte, and scans fewer
    rows (leaf_batch 2 so the ladder has budgets at this size)."""
    X, y = _engine_data(n=N_ROWS.get(name, 4000))
    extra = dict(extra, tpu_leaf_batch=2)
    b0 = _train(X, y, {**extra, "tpu_hist_partition": "false"})
    b1 = _train(X, y, {**extra, "tpu_hist_partition": "true"})
    assert not b0.engine.hist_partition and b1.engine.hist_partition
    if name == "goss_compact":
        assert b1.engine.use_goss_compact
    assert b0.model_to_string() == b1.model_to_string()
    n_pad = b0.engine.data.n_pad
    if name in ("full_row", "bagging"):
        assert b0.engine.hist_rows_scanned % n_pad == 0
    assert 0 < b1.engine.hist_rows_scanned < b0.engine.hist_rows_scanned


def test_engine_close_under_f32():
    """f32 histograms differ in summation order only."""
    X, y = _engine_data(seed=5)
    b0 = _train(X, y, {"tpu_hist_partition": "false"})
    b1 = _train(X, y, {"tpu_hist_partition": "true"})
    np.testing.assert_allclose(b1.predict(X), b0.predict(X), rtol=2e-2,
                               atol=2e-3)


def test_auto_engages_only_on_the_cuda_full_row_path():
    """``auto`` stands in for the JAX package's Pallas test with "the
    CUDA kernels are in use": the card measured the partition slower at
    every size, so ``auto`` stays masked on every device (on the card it
    logs ``PARTITION_STAND_DOWN``, which cites the measurement), GOSS
    included; ``true`` engages, as the reference's CPU tests force it."""
    from lightgbm_tpu_torch import capabilities
    why = capabilities.PARTITION_STAND_DOWN
    assert "PERF.md" in why and "H100" in why
    X, y = _engine_data(n=3000)
    assert not _train(X, y, {}, rounds=1).engine.hist_partition
    assert not _train(X, y, {"data_sample_strategy": "goss"},
                      rounds=1).engine.hist_partition
    assert _train(X, y, {"tpu_hist_partition": "true"},
                  rounds=1).engine.hist_partition

