"""Port parity: row compaction (kernel B's contract) and the JAX plan.

``plan_compaction`` and the one-call compaction ``compact_by_mask`` must be
bit-equal to the JAX reference as its CPU tests run it
(``plan_compaction`` + ``compact_rows_xla``), at several keep fractions
including the edges, and where more rows are kept than the buffer holds
(the plan's clamp engages and columns past ``out_cols`` are dropped). The
CUDA kernel is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import compact as jc
from lightgbm_tpu_torch.ops import compact as tc


def _mk(n, F, C, frac, seed):
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, 256, size=(F, n)).astype(np.uint8)
    vals_t = rng.normal(size=(C, n)).astype(np.float32)
    mask = rng.uniform(size=n) < frac
    return bins_t, vals_t, mask


@pytest.mark.parametrize("n,F,C,frac,R", [
    (8192, 28, 4, 0.3, 1024),      # the GOSS shape, scaled down
    (4096, 5, 3, 0.0, 256),        # nothing kept
    (4096, 7, 2, 1.0, 512),        # everything kept
    (6144, 3, 4, 0.02, 1024),      # sparse
])
def test_plan_and_compaction_bit_equal(n, F, C, frac, R):
    bins_t, vals_t, mask = _mk(n, F, C, frac, seed=n + F)
    out_cols = jc.compaction_out_cols(int(mask.sum()), R, 1024)
    assert tc.compaction_out_cols(int(mask.sum()), R, 1024) == out_cols
    jplan = [np.asarray(a) for a in
             jc.plan_compaction(jnp.asarray(mask), R, out_cols)]
    tplan = tc.plan_compaction(torch.from_numpy(mask), R, out_cols)
    for a, b in zip(jplan, tplan):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(a, b.numpy())
    jb, jv = jc.compact_rows_xla(
        jnp.asarray(bins_t.view(np.int8)), jnp.asarray(vals_t),
        *[jnp.asarray(a) for a in jplan], out_cols=out_cols,
        rows_per_block=R)
    before = tc.compact_by_mask.launches
    tb, tv = tc.compact_by_mask(torch.from_numpy(bins_t),
                                torch.from_numpy(vals_t),
                                torch.from_numpy(mask), out_cols)
    assert tc.compact_by_mask.launches == before      # CPU: no kernel
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).view(np.uint8))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    k = int(mask.sum())
    np.testing.assert_array_equal(tb.numpy()[:, :k], bins_t[:, mask])
    assert not tb.numpy()[:, k:].any() and not tv.numpy()[:, k:].any()


def test_clamp_drops_columns_past_out_cols():
    """More rows kept than ``out_cols - R - 128``: the JAX plan clamps its
    block write positions, its positions stay exact and those at or past
    ``out_cols`` are dropped; the one-call form drops the same columns."""
    n, F, C, R = 8192, 6, 3, 1024
    bins_t, vals_t, mask = _mk(n, F, C, 0.6, seed=11)
    k = int(mask.sum())
    out_cols = 4096
    assert k > out_cols > k - R - 128 and (out_cols - R - 128) < k
    jplan = jc.plan_compaction(jnp.asarray(mask), R, out_cols)
    tplan = tc.plan_compaction(torch.from_numpy(mask), R, out_cols)
    for a, b in zip(jplan, tplan):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    stream = np.concatenate([[0], np.cumsum(mask.reshape(-1, R).sum(1))])
    assert (np.asarray(jplan[1]) * 128 < stream[:-1]).any()   # clamped
    jb, jv = jc.compact_rows_xla(
        jnp.asarray(bins_t.view(np.int8)), jnp.asarray(vals_t), *jplan,
        out_cols=out_cols, rows_per_block=R)
    tb, tv = tc.compact_by_mask(torch.from_numpy(bins_t),
                                torch.from_numpy(vals_t),
                                torch.from_numpy(mask), out_cols)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).view(np.uint8))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    np.testing.assert_array_equal(tb.numpy(), bins_t[:, mask][:, :out_cols])


def test_wrapper_rejects_bad_inputs():
    bins = torch.zeros((2, 1024), dtype=torch.uint8)
    vals = torch.zeros((3, 1024), dtype=torch.float32)
    keep = torch.ones(1024, dtype=torch.bool)
    with pytest.raises(ValueError):
        tc.compact_by_mask(bins.to(torch.int8), vals, keep, 2048)
    with pytest.raises(ValueError):
        tc.compact_by_mask(bins, vals, keep.to(torch.int32), 2048)
    with pytest.raises(ValueError):
        tc.compact_by_mask(bins, vals[:, :512], keep, 2048)
    with pytest.raises(ValueError):
        tc.compact_by_mask(bins, vals, keep, 0)
