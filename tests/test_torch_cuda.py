"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (``pytest.mark.cuda``) and
skips without one. This file imports neither JAX nor ``lightgbm_tpu``, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py configures JAX.)
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import compact as tc
from lightgbm_tpu_torch.ops import hist_probes as hp
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import partition as tp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _hist_data(n, F, B, C, n_leaves, int_levels, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    if int_levels:
        vals = rng.integers(-3, 4, size=(C, n)).astype(np.float32)
    else:
        vals = rng.normal(size=(C, n)).astype(np.float32)
    vals[-1] = (rng.random(n) < 0.8).astype(np.float32)
    leaf_id = rng.integers(0, n_leaves, size=n).astype(np.int32)
    return [torch.from_numpy(bins), torch.from_numpy(vals),
            torch.from_numpy(leaf_id)]


def _exact_f32_vals(rng, C, n):
    """f32 values whose bf16 roundings are k/128 (|k| in 1..256), each off
    its rounding by up to 2^-10 relative: cells of up to 2^16 rows sum
    exactly in float32 in any order, so an f32-mode kernel that keeps the
    bf16 operands is bit-equal to the plain version, and one that sums
    the unrounded values is not."""
    k = rng.integers(1, 257, size=(C, n)) * rng.choice([-1, 1], size=(C, n))
    r = rng.uniform(-2.0 ** -10, 2.0 ** -10, size=(C, n))
    return torch.from_numpy((k / 128 * (1 + r)).astype(np.float32))


@pytest.mark.parametrize("int_mode", [True, False])
@pytest.mark.parametrize("n,F,B,ids", [
    (100_000, 28, 256, [0, 3, -1, 7, 11, 39, 2, -1]),
    (65_536, 5, 64, list(range(32)) + [-1, 5000, 40, 41]),   # 2 lane groups
    (4096, 3, 8, [1, 1, 2]),                                  # repeated id
    (4099, 4, 32, [0, 2, 3]),                 # n % 4 != 0: the scalar path
])
def test_histogram_kernel_matches_plain(cuda_device, int_mode, n, F, B, ids):
    args = _hist_data(n, F, B, 3, 42, int_mode, seed=n + F)
    args.append(torch.tensor(ids, dtype=torch.int32))
    plain = th.multi_leaf_histogram_plain(*args, num_bins=B,
                                          int_mode=int_mode)
    before = th.multi_leaf_histogram.launches
    out = th.multi_leaf_histogram(*[a.to(cuda_device) for a in args],
                                  num_bins=B, int_mode=int_mode).cpu()
    assert th.multi_leaf_histogram.launches == before + 1
    if int_mode:
        assert torch.equal(out, plain)
    else:
        # same bf16-rounded operands, f32 sums in another order
        vb = args[1].to(torch.bfloat16).float()
        tol = 2.0 ** -20 * vb.abs().sum(1)
        assert bool(((out - plain).abs() <= tol).all())
        # on exact-sum values: bit-equal, so the bf16 operands are kept
        args[1] = _exact_f32_vals(np.random.default_rng(n), 3, n)
        plain = th.multi_leaf_histogram_plain(*args, num_bins=B)
        out = th.multi_leaf_histogram(*[a.to(cuda_device) for a in args],
                                      num_bins=B)
        assert torch.equal(out.cpu(), plain)


@pytest.mark.parametrize("int_mode", [True, False])
def test_histogram_kernel_on_spans(cuda_device, int_mode):
    """One span round of the partitioned grow loop: windows cut by
    ``slice_spans`` from a leaf-grouped layout, with -1 ids on the rows
    of neighbouring leaves, inactive -1 lanes and a clamped last window;
    bit-equal to the plain version (f32 mode on exact-sum values)."""
    rng = np.random.default_rng(11)
    n, F, B, L, S = 40_000, 6, 64, 31, 1024
    bins = torch.from_numpy(rng.integers(0, B, size=(F, n)).astype(np.uint8))
    vals = (torch.from_numpy(rng.integers(-3, 4, size=(3, n))
                             .astype(np.float32)) if int_mode
            else _exact_f32_vals(rng, 3, n))
    # 8 elected children of at most S rows, the last leaf among them (its
    # window's start clamps), the other leaves share the rest
    ids = np.append(rng.permutation(L - 1)[:7], L - 1).astype(np.int32)
    cnt = np.zeros(L, np.int64)
    cnt[ids] = rng.integers(1, S + 1, size=8)
    rest = np.setdiff1d(np.arange(L), ids)
    cnt[rest] = rng.multinomial(n - cnt.sum(), np.ones(rest.size) / rest.size)
    ids[[2, 5]] = -1
    off = np.cumsum(cnt) - cnt
    leaf = torch.from_numpy(np.repeat(np.arange(L), cnt).astype(np.int32))
    small = torch.from_numpy(ids)
    safe = small.clamp(0, L - 1).long()
    offs = torch.from_numpy(off.astype(np.int32))[safe]
    cnts = torch.where(small >= 0,
                       torch.from_numpy(cnt.astype(np.int32))[safe], 0)
    args = list(tp.slice_spans(bins, vals, leaf, offs, cnts, S)) + [small]
    assert int((args[2] == -1).sum()) > 0
    plain = th.multi_leaf_histogram_plain(*args, num_bins=B,
                                          int_mode=int_mode)
    out = th.multi_leaf_histogram(*[a.to(cuda_device) for a in args],
                                  num_bins=B, int_mode=int_mode)
    assert torch.equal(out.cpu(), plain)


@pytest.mark.parametrize("n,F,C,frac,R", [
    (65_536, 28, 4, 0.3, 1024), (65_536, 28, 4, 1.0, 1024),
    (8192, 3, 2, 0.0, 256), (20_480, 9, 5, 0.05, 512)])
def test_compaction_kernel_matches_plain(cuda_device, n, F, C, frac, R):
    rng = np.random.default_rng(n + F)
    bins_t = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                              .astype(np.uint8))
    vals_t = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=n) < frac)
    out_cols = tc.compaction_out_cols(int(mask.sum()), R, 4096)
    plan = tc.plan_compaction(mask, R, out_cols)
    args = [bins_t, vals_t, *plan]
    pb, pv = tc.compact_rows_plain(*args, out_cols=out_cols,
                                   rows_per_block=R)
    before = tc.compact_rows.launches
    kb, kv = tc.compact_rows(*[a.to(cuda_device) for a in args],
                             out_cols=out_cols, rows_per_block=R)
    assert tc.compact_rows.launches == before + 1
    assert torch.equal(kb.cpu(), pb)
    assert torch.equal(kv.cpu().view(torch.int32), pv.view(torch.int32))


def test_histogram_kernel_misaligned_rows(cuda_device):
    """Contiguous inputs that start off a 16-byte boundary take the
    scalar path and give the same sums."""
    bins, vals, leaf = _hist_data(8192, 6, 64, 3, 8, True, seed=9)
    ids = torch.tensor([0, 3, 5, -1], dtype=torch.int32)
    plain = th.multi_leaf_histogram_plain(bins, vals, leaf, ids, num_bins=64,
                                          int_mode=True)
    buf = torch.zeros(vals.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(vals.shape)
    shifted.copy_(vals.to(cuda_device))
    out = th.multi_leaf_histogram(bins.to(cuda_device), shifted,
                                  leaf.to(cuda_device), ids.to(cuda_device),
                                  num_bins=64, int_mode=True)
    assert torch.equal(out.cpu(), plain)


def test_wrappers_launch_only_on_cuda_tensors(cuda_device):
    """A CUDA tensor goes to the kernel (the count moves); a CPU tensor
    to the plain version (it does not)."""
    args = _hist_data(2048, 2, 16, 3, 4, True, seed=0)
    args.append(torch.tensor([0, 1], dtype=torch.int32))
    before = th.multi_leaf_histogram.launches
    th.multi_leaf_histogram(*args, num_bins=16, int_mode=True)
    assert th.multi_leaf_histogram.launches == before
    th.multi_leaf_histogram(*[a.to(cuda_device) for a in args], num_bins=16,
                            int_mode=True)
    assert th.multi_leaf_histogram.launches == before + 1


@pytest.mark.parametrize("n,F,C,frac", [
    (65_536, 28, 3, 0.5), (65_536, 28, 3, 0.001), (4099, 5, 3, 0.3),
    (8191, 28, 3, 0.0), (8191, 28, 3, 1.0), (1000, 2, 1, 0.7)])
def test_partition_move_matches_plain(cuda_device, n, F, C, frac):
    """Bit-equal to the plain scatter, for odd n and for a moved fraction
    of 0 and of 1; the kernel writes into a given second buffer."""
    rng = np.random.default_rng(n + F)
    bins_t = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                              .astype(np.uint8))
    vals_t = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32))
    leaf = torch.from_numpy(rng.integers(0, 127, size=n).astype(np.int32))
    dest, _, _ = tp.plan_split_move(torch.from_numpy(rng.uniform(size=n)
                                                     < frac))
    args = [bins_t, vals_t, leaf, dest]
    pb, pv, pl = tp.move_rows_plain(*args)
    cargs = [a.to(cuda_device) for a in args]
    out = tuple(torch.full_like(a, 7) for a in cargs[:3])
    before = tp.move_cols.launches
    kb, kv, kl = tp.move_cols(*cargs, out=out)
    assert tp.move_cols.launches == before + 1
    assert kb is out[0] and kv is out[1] and kl is out[2]
    assert torch.equal(kb.cpu(), pb) and torch.equal(kl.cpu(), pl)
    assert torch.equal(kv.cpu().view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("probe", ["1d", "nibble16", "nibble32",
                                   "nibble64"])
@pytest.mark.parametrize("n,F,B,C,K,zeros", [
    (65_536, 28, 256, 3, 16, True),       # kernel_probe.py's leaf ids
    (65_536, 28, 256, 3, 32, False),      # nibble_probe.py's leaf ids
    (4099, 5, 64, 4, 6, False),           # n % 4 != 0
    (2048, 3, 40, 8, 3, False),           # B not a multiple of nb
])
def test_hist_probes_match_plain(cuda_device, probe, n, F, B, C, K, zeros):
    rng = np.random.default_rng(n + K)
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    vals = rng.normal(size=(C, n)).astype(np.float32)
    leaf = (np.zeros(n, np.int32) if zeros
            else rng.integers(0, K, size=n).astype(np.int32))
    ids = np.arange(K, dtype=np.int32)
    if not zeros:
        ids[1::5] = -1
    args = [torch.from_numpy(a) for a in (bins, vals, leaf, ids)]
    plain = th.multi_leaf_histogram_plain(*args, num_bins=B)
    cargs = [a.to(cuda_device) for a in args]
    if probe == "1d":
        fn, before = hp.hist_probe_1d, hp.hist_probe_1d.launches
        out = fn(*cargs, num_bins=B)
    else:
        fn, before = hp.hist_probe_nibble, hp.hist_probe_nibble.launches
        out = fn(*cargs, num_bins=B, nb=int(probe[6:]))
    assert fn.launches == before + 1
    vb = args[1].to(torch.bfloat16).float()
    tol = 2.0 ** -20 * vb.abs().sum(1)
    assert bool(((out.cpu() - plain).abs() <= tol).all())
    # on exact-sum values: bit-equal, so the bf16 operands are kept
    args[1] = _exact_f32_vals(rng, C, n)
    plain = th.multi_leaf_histogram_plain(*args, num_bins=B)
    cargs[1] = args[1].to(cuda_device)
    out = (fn(*cargs, num_bins=B) if probe == "1d"
           else fn(*cargs, num_bins=B, nb=int(probe[6:])))
    assert torch.equal(out.cpu(), plain)
