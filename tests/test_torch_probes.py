"""Port parity: the two histogram probe kernels' wrappers.

``hist_probe_1d`` and ``hist_probe_nibble`` compute the multi-leaf
histogram in f32 mode (bf16 operands, f32 sums). On the CPU they run
``multi_leaf_histogram_plain(int_mode=False)`` and must equal it exactly;
against the JAX package's ``multi_leaf_histogram_xla`` (as its CPU tests
run it) they agree within the f32 summation-order bound, 2^-20 x the
channel's sum of |bf16 values|. Their kernels are held against the plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas_histogram import multi_leaf_histogram_xla
from lightgbm_tpu_torch.ops import hist_probes as hp
from lightgbm_tpu_torch.ops import histogram as th

# small versions of the probes' shapes (benchmarks/kernel_probe.py:7-12:
# every leaf id 0, K=16; benchmarks/nibble_probe.py:25-31: ids uniform in
# [0, K), K=32), plus inactive and unmatched lanes
CASES = [
    ("1d_shape", 4096, 28, 256, 3, 16, "zeros"),
    ("nibble_shape", 4096, 28, 256, 3, 32, "uniform"),
    ("n3000", 3000, 5, 64, 4, 6, "uniform"),
    ("narrow", 2048, 3, 8, 2, 3, "uniform"),
]
PROBES = [("1d", lambda *a, **k: hp.hist_probe_1d(*a, **k))] + [
    (f"nibble{nb}", lambda *a, nb=nb, **k: hp.hist_probe_nibble(*a, nb=nb,
                                                                 **k))
    for nb in hp.NIBBLE_WIDTHS]


def _data(n, F, B, C, K, leaves, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    vals = rng.normal(size=(C, n)).astype(np.float32)
    if leaves == "zeros":
        leaf = np.zeros(n, np.int32)
        ids = np.arange(K, dtype=np.int32)
    else:
        leaf = rng.integers(0, K, size=n).astype(np.int32)
        ids = np.arange(K, dtype=np.int32)
        ids[1::5] = -1                          # inactive lanes
    return bins, vals, leaf, ids


@pytest.mark.parametrize("probe", [p[1] for p in PROBES],
                         ids=[p[0] for p in PROBES])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_probe_cpu_route(case, probe):
    _, n, F, B, C, K, leaves = case
    bins, vals, leaf, ids = _data(n, F, B, C, K, leaves, seed=n + K)
    args = [torch.from_numpy(a) for a in (bins, vals, leaf, ids)]
    counts = (hp.hist_probe_1d.launches, hp.hist_probe_nibble.launches)
    got = probe(*args, num_bins=B)
    assert counts == (hp.hist_probe_1d.launches,
                      hp.hist_probe_nibble.launches)  # CPU: no kernel
    plain = th.multi_leaf_histogram_plain(*args, num_bins=B, int_mode=False)
    assert got.shape == (K, F, B, C) and got.dtype == torch.float32
    assert torch.equal(got, plain)
    ref = np.asarray(multi_leaf_histogram_xla(
        jnp.asarray(bins.T), jnp.asarray(vals.T), jnp.asarray(leaf),
        jnp.asarray(ids), num_bins=B, rows_per_block=math.gcd(n, 512)))
    vb = args[1].to(torch.bfloat16).float().abs().sum(1).numpy()
    assert np.all(np.abs(got.numpy() - ref) <= 2.0 ** -20 * vb)


def test_probes_refuse_more_than_32_lanes():
    bins, vals, leaf, ids = _data(256, 2, 8, 3, 33, "uniform", seed=0)
    args = [torch.from_numpy(a) for a in (bins, vals, leaf, ids)]
    for fn in (hp.hist_probe_1d, hp.hist_probe_nibble):
        with pytest.raises(ValueError, match="32 lanes"):
            fn(*args, num_bins=8)
