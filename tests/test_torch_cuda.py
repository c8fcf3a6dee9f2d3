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
from lightgbm_tpu_torch.ops import histogram as th

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
