"""Port parity: row compaction (kernel B's contract) and its plan.

``plan_compaction`` and the compaction output must be bit-equal to the
JAX reference as its CPU tests run it (``plan_compaction`` +
``compact_rows_xla``), at several keep fractions including the edges.
The CUDA kernel is compared with the plain version on the card
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
    tb, tv = tc.compact_rows(torch.from_numpy(bins_t),
                             torch.from_numpy(vals_t), *tplan,
                             out_cols=out_cols, rows_per_block=R)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb).view(np.uint8))
    np.testing.assert_array_equal(tv.numpy().view(np.uint32),
                                  np.asarray(jv).view(np.uint32))
    k = int(mask.sum())
    np.testing.assert_array_equal(tb.numpy()[:, :k], bins_t[:, mask])
    assert not tb.numpy()[:, k:].any() and not tv.numpy()[:, k:].any()


def test_wrapper_rejects_bad_inputs():
    bins = torch.zeros((2, 1024), dtype=torch.uint8)
    vals = torch.zeros((3, 1024), dtype=torch.float32)
    plan = tc.plan_compaction(torch.ones(1024, dtype=torch.bool), 256, 2048)
    with pytest.raises(ValueError):
        tc.compact_rows(bins.to(torch.int8), vals, *plan, out_cols=2048,
                        rows_per_block=256)
    with pytest.raises(ValueError):
        tc.compact_rows(bins, vals, *plan, out_cols=2048, rows_per_block=512)
    with pytest.raises(ValueError):
        tc.compact_rows(bins, vals[:, :512], *plan, out_cols=2048,
                        rows_per_block=256)
