"""Port parity: the two histogram probe kernels' wrappers.

``hist_probe_1d`` and ``hist_probe_nibble`` compute the multi-leaf
histogram in f32 mode (bf16 operands, f32 sums). On the CPU they run
``multi_leaf_histogram_plain(int_mode=False)`` and must equal it exactly;
against the JAX package's ``multi_leaf_histogram_xla`` (as its CPU tests
run it) they agree within the f32 summation-order bound, 2^-20 x the
channel's sum of |bf16 values|. Each is also held against the TPU probe
it replaces, run in Pallas interpret mode: ``hist_probe_nibble`` against
``benchmarks/nibble_probe.py::hist_nibble``, ``hist_probe_1d`` against
``benchmarks/kernel_probe.py::hist1d``. Their kernels are held against
the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import ast
import functools
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

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


@pytest.fixture(scope="module")
def nibble_probe():
    """``benchmarks/nibble_probe.py`` imported unchanged as a module (its
    timing loop is under ``__main__``; its module-level probe arrays take
    about 40 MB)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "nibble_probe.py")
    spec = importlib.util.spec_from_file_location("nibble_probe_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nb,B,K,n", [(16, 64, 4, 4096),
                                      (32, 64, 8, 4096),
                                      (64, 128, 6, 6144)])
def test_nibble_matches_tpu_probe(nibble_probe, monkeypatch, nb, B, K, n):
    """The port's nibble probe (CPU route) against the TPU probe itself,
    ``hist_nibble`` with ``pl.pallas_call`` run in interpret mode, within
    2^-20 x the channel's sum of |bf16 values| (the probe sums bf16
    products in f32 on the matrix unit, in another order).

    Where the reference differs, the inputs stay out of the way: its
    ``lid == sm`` lets a -1 row match a -1 lane (the port's rule: a
    negative leaf id matches no lane), so every leaf id here is
    non-negative and the -1 lanes are zero in both; its ``n_hi =
    num_bins // nb`` computes no bin at or above (B // nb) * nb, so B is
    a multiple of nb; its grid ``n // rows_per_block`` needs n to be a
    multiple of the block (2048)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    F, C = 3, 3
    rng = np.random.default_rng(nb + B + K)
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    vals = rng.normal(size=(C, n)).astype(np.float32)
    leaf = rng.integers(0, K + 2, size=n).astype(np.int32)
    ids = np.arange(K, dtype=np.int32)
    ids[[1, K - 2]] = -1                        # inactive lanes
    args = [torch.from_numpy(a) for a in (bins, vals, leaf, ids)]
    got = hp.hist_probe_nibble(*args, num_bins=B, nb=nb).numpy()
    ref = np.asarray(nibble_probe.hist_nibble(
        jnp.asarray(bins.astype(np.int8)), jnp.asarray(vals),
        jnp.asarray(leaf), jnp.asarray(ids), num_bins=B, nb=nb))
    assert ref.shape == got.shape == (K, F, B, C)
    assert not got[[1, K - 2]].any() and not ref[[1, K - 2]].any()
    vb = args[1].to(torch.bfloat16).float().abs().sum(1).numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -20 * vb)


@pytest.fixture(scope="module")
def kernel_probe():
    """``_kernel1d`` and ``hist1d`` of ``benchmarks/kernel_probe.py``, the
    file unchanged: it runs a 1M-row benchmark at import, so only those
    two function definitions are taken from its syntax tree and run in a
    namespace of the names they use."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "kernel_probe.py")
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    tree.body = [node for node in tree.body
                 if isinstance(node, ast.FunctionDef)
                 and node.name in ("_kernel1d", "hist1d")]
    assert len(tree.body) == 2
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, functools=functools)
    exec(compile(tree, path, "exec"), ns)
    return ns


@pytest.mark.parametrize("F,n,B,K,R", [(3, 4096, 64, 4, 1024),
                                       (2, 2048, 32, 6, 512),
                                       (4, 3072, 16, 3, 1024)])
def test_probe_1d_matches_tpu_probe(kernel_probe, monkeypatch, F, n, B, K,
                                    R):
    """The port's 1-D probe (CPU route) against the TPU probe itself,
    ``hist1d`` with ``pl.pallas_call`` run in interpret mode, within 2^-20
    x the channel's sum of |bf16 values| (the probe sums bf16 products in
    f32 on the matrix unit, in another order).

    Every leaf id here is non-negative: the probe's ``lid == sm`` lets a
    -1 row match a -1 lane, while the port keeps the JAX package's
    documented rule for kernel A, which the probe probes (a negative leaf
    id matches no lane, ``lightgbm_tpu/ops/pallas_histogram.py``). So the
    -1 lane is zero in both. Its grid ``n // rows_per_block`` needs n to
    be a multiple of the block."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    C = 3
    rng = np.random.default_rng(F * n + B + K)
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    vals = rng.normal(size=(C, n)).astype(np.float32)
    leaf = rng.integers(0, K + 1, size=n).astype(np.int32)
    ids = np.arange(K, dtype=np.int32)
    ids[1] = -1                                 # an inactive lane
    args = [torch.from_numpy(a) for a in (bins, vals, leaf, ids)]
    got = hp.hist_probe_1d(*args, num_bins=B).numpy()
    ref = np.asarray(kernel_probe["hist1d"](
        jnp.asarray(bins.astype(np.int8)), jnp.asarray(vals),
        jnp.asarray(leaf), jnp.asarray(ids), num_bins=B,
        rows_per_block=R))
    assert ref.shape == got.shape == (K, F, B, C)
    assert not got[1].any() and not ref[1].any()
    vb = args[1].to(torch.bfloat16).float().abs().sum(1).numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -20 * vb)
