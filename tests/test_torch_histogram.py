"""Port parity: the multi-leaf histogram (kernel A's contract).

The JAX reference runs as its own CPU tests run it
(``multi_leaf_histogram_xla``, bf16 operands, f32 accumulation). In int
mode (quantized gradient levels) both sides are exact, so they must be
bit-equal; in f32 mode the only differences are the order of the f32
sums of identical bf16-rounded values, bounded relative to the channel's
sum of magnitudes. The CUDA kernel itself is compared with the plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas_histogram import multi_leaf_histogram_xla
from lightgbm_tpu_torch.ops import histogram as th


def _data(n, F, B, C, n_leaves, int_levels, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
    if int_levels:
        vals = rng.integers(-3, 4, size=(n, C)).astype(np.float32)
    else:
        vals = rng.normal(size=(n, C)).astype(np.float32)
    vals[:, -1] = (rng.random(n) < 0.8).astype(np.float32)   # count mask
    leaf_id = rng.integers(0, n_leaves, size=n).astype(np.int32)
    return bins, vals, leaf_id


def _jax(bins, vals, leaf_id, small_ids, B):
    return np.asarray(multi_leaf_histogram_xla(
        jnp.asarray(bins), jnp.asarray(vals), jnp.asarray(leaf_id),
        jnp.asarray(small_ids), num_bins=B, rows_per_block=512))


def _port(bins, vals, leaf_id, small_ids, B, int_mode):
    return th.multi_leaf_histogram(
        torch.from_numpy(bins.T.copy()), torch.from_numpy(vals.T.copy()),
        torch.from_numpy(leaf_id), torch.from_numpy(small_ids),
        num_bins=B, int_mode=int_mode).numpy()


@pytest.mark.parametrize("n,F,B,C,small_ids", [
    (2048, 6, 32, 3, [3, 0, -1, 4]),
    (4096, 28, 256, 3, [0, 5, 9, -1, -1, 2, 7, 1]),
    (1024, 5, 64, 4, [-1]),
    (3072, 3, 8, 3, [1, 1, 2]),          # a repeated id: both lanes equal
    (2048, 4, 256, 2, [4000, 2, -7]),    # ids that match nothing
])
def test_int_mode_bit_equal_to_reference(n, F, B, C, small_ids):
    bins, vals, leaf_id = _data(n, F, B, C, 10, True, seed=n + F)
    ids = np.asarray(small_ids, np.int32)
    ref = _jax(bins, vals, leaf_id, ids, B)
    out = _port(bins, vals, leaf_id, ids, B, int_mode=True)
    assert out.shape == (len(ids), F, B, C) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    for k, lid in enumerate(ids):
        if not (leaf_id == lid).any():
            assert np.all(out[k] == 0.0)


@pytest.mark.parametrize("n,F,B,K", [(2048, 6, 32, 4), (4096, 28, 256, 8)])
def test_f32_mode_within_order_tolerance(n, F, B, K):
    """f32 mode: same bf16-rounded operands, f32 sums in another order.
    Bound: |diff| <= 2^-20 * sum|bf16(vals)| of the channel (float32
    accumulation error over at most n terms is far below this)."""
    bins, vals, leaf_id = _data(n, F, B, 3, 2 * K, False, seed=K)
    ids = np.arange(K, dtype=np.int32)
    ids[-1] = -1
    ref = _jax(bins, vals, leaf_id, ids, B)
    out = _port(bins, vals, leaf_id, ids, B, int_mode=False)
    vb = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    tol = 2.0 ** -20 * np.abs(vb).sum(axis=0)
    assert np.all(np.abs(out - ref) <= tol[None, None, None, :])
    # the count channel is exact in any order
    np.testing.assert_array_equal(out[..., -1], ref[..., -1])


def test_cpu_wrapper_is_the_plain_version():
    bins, vals, leaf_id = _data(1024, 4, 16, 3, 5, False, seed=3)
    args = (torch.from_numpy(bins.T.copy()), torch.from_numpy(vals.T.copy()),
            torch.from_numpy(leaf_id),
            torch.tensor([0, 2, -1], dtype=torch.int32))
    a = th.multi_leaf_histogram(*args, num_bins=16)
    b = th.multi_leaf_histogram_plain(*args, num_bins=16)
    assert torch.equal(a, b)


def test_wrapper_rejects_bad_inputs():
    bins = torch.zeros((3, 64), dtype=torch.uint8)
    vals = torch.zeros((3, 64), dtype=torch.float32)
    lid = torch.zeros(64, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        th.multi_leaf_histogram(bins.to(torch.int8), vals, lid, ids,
                                num_bins=8)
    with pytest.raises(ValueError):
        th.multi_leaf_histogram(bins, vals[:, :32], lid, ids, num_bins=8)
    with pytest.raises(ValueError):
        th.multi_leaf_histogram(bins, vals, lid.long(), ids, num_bins=8)
    with pytest.raises(ValueError):
        th.multi_leaf_histogram(bins, vals, lid, ids, num_bins=257)
    with pytest.raises(ValueError):
        th.multi_leaf_histogram(bins.T.contiguous().T, vals, lid, ids,
                                num_bins=8)
