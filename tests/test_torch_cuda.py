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


@pytest.mark.parametrize("int_mode", [True, False])
@pytest.mark.parametrize("case", [
    "one_lane_all_rows", "skewed_bins", "k40_two_groups", "c1", "c8",
    "b63", "b255", "n_misaligned", "wide_blocks"])
def test_histogram_kernel_shapes(cuda_device, int_mode, case):
    """The kernel's paths: one live lane over every row (32 replicas),
    90% of each feature's rows in one bin, K > 32 (two lane groups), one
    and eight channels (eight: fewer lanes per group), odd and near-full
    bin counts, n % 4 != 0 (the scalar path), and n >= 2^19 (blocks of
    two features, an odd F). Int mode bit-equal to the plain version;
    f32 mode bit-equal on exact-sum values."""
    n, F, B, C, K, n_leaves = 100_000, 6, 256, 3, 8, 8
    if case == "one_lane_all_rows":
        n, F = 200_000, 28
    elif case == "k40_two_groups":
        K, n_leaves = 40, 46
    elif case in ("c1", "c8"):
        C = int(case[1:])
        K = 32 if case == "c8" else K
    elif case in ("b63", "b255"):
        B = int(case[1:])
    elif case == "n_misaligned":
        n, F = 10_001, 5
    elif case == "wide_blocks":         # n >= 2^19: two-feature blocks
        n, F, K, n_leaves = 600_000, 5, 32, 40
    rng = np.random.default_rng(len(case) + 7 * int_mode)
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    if case == "skewed_bins":
        bins[rng.random((F, n)) < 0.9] = 17
    leaf = rng.integers(0, n_leaves, size=n).astype(np.int32)
    ids = np.arange(K, dtype=np.int32)
    ids[3::7] = -1
    if case == "one_lane_all_rows":
        leaf[:] = 0
        ids[:] = -1
        ids[0] = 0
    vals = (torch.from_numpy(rng.integers(-3, 4, size=(C, n))
                             .astype(np.float32)) if int_mode
            else _exact_f32_vals(rng, C, n))
    args = [torch.from_numpy(bins), vals, torch.from_numpy(leaf),
            torch.from_numpy(ids)]
    plain = th.multi_leaf_histogram_plain(*args, num_bins=B,
                                          int_mode=int_mode)
    before = th.multi_leaf_histogram.launches
    out = th.multi_leaf_histogram(*[a.to(cuda_device) for a in args],
                                  num_bins=B, int_mode=int_mode)
    assert th.multi_leaf_histogram.launches == before + 1
    out = out.cpu()
    assert torch.equal(out, plain)
    assert bool((out[torch.from_numpy(ids < 0)] == 0).all())


@pytest.mark.parametrize("n,F,C,frac,R", [
    (65_536, 28, 4, 0.3, 1024), (65_536, 28, 4, 1.0, 1024),
    (8192, 3, 2, 0.0, 256), (20_480, 9, 5, 0.05, 512),
    # multiclass GOSS: 2K + 2 value rows, K = 3.5 (odd) and K = 7
    (20_480, 9, 9, 0.05, 512), (65_536, 54, 16, 0.15, 1024)])
def test_compaction_kernel_matches_plain(cuda_device, n, F, C, frac, R):
    rng = np.random.default_rng(n + F)
    bins_t = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                              .astype(np.uint8))
    vals_t = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(size=n) < frac)
    out_cols = tc.compaction_out_cols(int(mask.sum()), R, 4096)
    args = [bins_t, vals_t, mask]
    pb, pv = tc.compact_by_mask_plain(*args, out_cols)
    before = tc.compact_by_mask.launches
    kb, kv = tc.compact_by_mask(*[a.to(cuda_device) for a in args],
                                out_cols)
    assert tc.compact_by_mask.launches == before + 1
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
    """Bit-equal to the plain version (moved columns, cum and n_front),
    for odd n and for a moved fraction of 0 and of 1; the kernel writes
    into a given second buffer."""
    args = _move_case(n, F, C, frac, seed=n + F)
    pmove, pnf, pcum = tp.partition_move_plain(*args)
    cargs = [a.to(cuda_device) for a in args]
    out = tuple(torch.full_like(a, 7) for a in (cargs[0], cargs[1],
                                                cargs[3]))
    before = tp.partition_move.launches
    kmove, knf, kcum = tp.partition_move(*cargs, out=out)
    assert tp.partition_move.launches == before + 1
    assert all(k is o for k, o in zip(kmove, out))
    _assert_move_equal((kmove, knf, kcum), (pmove, pnf, pcum))


# ---- the stable-partition kernels (partition move B', compaction B) -----
TILE = 4096               # columns per tile (csrc/stable_partition.cuh)


def _move_case(n, F, C, frac, seed):
    """bins, values, old and new leaf ids: a fraction ``frac`` of the
    positions changes its id."""
    rng = np.random.default_rng(seed)
    bins_t = rng.integers(0, 256, size=(F, n)).astype(np.uint8)
    vals_t = rng.normal(size=(C, n)).astype(np.float32)
    old = rng.integers(0, 127, size=n).astype(np.int32)
    new = np.where(rng.uniform(size=n) < frac, old + 127, old)
    return [torch.from_numpy(a) for a in (bins_t, vals_t, old,
                                          new.astype(np.int32))]


def _assert_move_equal(got, want):
    (kb, kv, kl), knf, kcum = got
    (pb, pv, pl), pnf, pcum = want
    assert torch.equal(kb.cpu(), pb.cpu()) and torch.equal(kl.cpu(),
                                                           pl.cpu())
    assert torch.equal(kv.cpu().view(torch.int32), pv.cpu().view(torch.int32))
    assert torch.equal(kcum.cpu(), pcum.cpu())
    assert knf.shape == () and int(knf) == int(pnf)


@pytest.mark.parametrize("frac", [0.0, 0.001, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 2_002_944,
                               (1 << 22) + 3])
def test_stable_partition_sizes(cuda_device, n, frac):
    """Both kernels at tile edges, the 2M-row run's padded width and past
    2^22 columns (n % 16 != 0: rows off 16-byte alignment take the
    scalar loads), bit-equal to their plain versions on the card."""
    F, C = 28, 3
    args = [a.to(cuda_device) for a in _move_case(n, F, C, frac, seed=n)]
    _assert_move_equal(tp.partition_move(*args),
                       tp.partition_move_plain(*args))
    keep = args[3] != args[2]
    vals4 = torch.cat([args[1], args[1][:1]])
    for out_cols in (n, max(1, int(keep.sum()) // 2)):
        kb, kv = tc.compact_by_mask(args[0], vals4, keep, out_cols)
        pb, pv = tc.compact_by_mask_plain(args[0], vals4, keep, out_cols)
        assert torch.equal(kb, pb)
        assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("F", [1, 28])
@pytest.mark.parametrize("C", [1, 3, 4, 8, 9, 16])
def test_stable_partition_widths(cuda_device, F, C):
    """One and 28 feature rows (a stage holds up to four), 1-16 value
    rows (multiclass GOSS compacts 2K + 2), two tiles and a part."""
    n = 2 * TILE + 777
    args = [a.to(cuda_device) for a in _move_case(n, F, C, 0.5, seed=F + C)]
    _assert_move_equal(tp.partition_move(*args),
                       tp.partition_move_plain(*args))
    keep = args[3] == args[2]
    out_cols = int(keep.sum()) + 300
    kb, kv = tc.compact_by_mask(args[0], args[1], keep, out_cols)
    pb, pv = tc.compact_by_mask_plain(args[0], args[1], keep, out_cols)
    assert torch.equal(kb, pb)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def test_stable_partition_launches_in_a_row(cuda_device):
    """Three launches of each kernel on one stream with no host sync in
    between, each with other flags: every launch reads only its own
    epoch's status words and counters."""
    n, F, C = 5 * TILE + 123, 28, 3
    cases = [[a.to(cuda_device) for a in _move_case(n, F, C, frac, seed=i)]
             for i, frac in enumerate((0.5, 0.001, 1.0))]
    torch.cuda.synchronize()
    got = [tp.partition_move(*c) for c in cases]
    kept = [tc.compact_by_mask(c[0], c[1], c[3] == c[2], n) for c in cases]
    torch.cuda.synchronize()
    for c, g, k in zip(cases, got, kept):
        _assert_move_equal(g, tp.partition_move_plain(*c))
        pb, pv = tc.compact_by_mask_plain(c[0], c[1], c[3] == c[2], n)
        assert torch.equal(k[0], pb)
        assert torch.equal(k[1].view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("case", ["more_than_out_cols", "all", "none"])
def test_compaction_kept_counts(cuda_device, case):
    """Kept columns past out_cols are dropped; everything kept; nothing
    kept (the whole output is the zero tail). uint8 and bool masks."""
    n, F, C = 3 * TILE + 5, 28, 4
    rng = np.random.default_rng(len(case))
    bins_t = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                              .astype(np.uint8)).to(cuda_device)
    vals_t = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32)) \
        .to(cuda_device)
    if case == "more_than_out_cols":
        keep = torch.from_numpy(rng.uniform(size=n) < 0.9)
        out_cols = TILE + 17
    else:
        keep = torch.full((n,), case == "all")
        out_cols = n + 100
    keep = keep.to(cuda_device)
    for mask in (keep, keep.to(torch.uint8)):
        kb, kv = tc.compact_by_mask(bins_t, vals_t, mask, out_cols)
        pb, pv = tc.compact_by_mask_plain(bins_t, vals_t, mask, out_cols)
        assert torch.equal(kb, pb)
        assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    if case == "none":
        assert not kb.any() and not kv.any()


def test_stable_partition_misaligned_rows(cuda_device):
    """Contiguous inputs and outputs that start off a 16-byte boundary:
    the rows take the scalar loads and the runs' chunks shift."""
    n, F, C = 2 * TILE + 64, 5, 3
    args = [a.to(cuda_device) for a in _move_case(n, F, C, 0.4, seed=3)]
    buf = torch.zeros(C * n + 1, device=cuda_device)
    shifted = buf[1:].view(C, n)
    shifted.copy_(args[1])
    args[1] = shifted
    obuf = torch.zeros(C * n + 1, device=cuda_device)
    out = (torch.empty_like(args[0]), obuf[1:].view(C, n),
           torch.empty_like(args[3]))
    _assert_move_equal(tp.partition_move(*args, out=out),
                       tp.partition_move_plain(*args))
    keep = args[3] != args[2]
    kb, kv = tc.compact_by_mask(args[0], shifted, keep, n - 1)
    pb, pv = tc.compact_by_mask_plain(args[0], shifted, keep, n - 1)
    assert torch.equal(kb, pb)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def test_stable_partition_wrappers_launch_only_on_cuda(cuda_device):
    args = _move_case(3000, 4, 3, 0.5, seed=0)
    keep = args[3] != args[2]
    b0, c0 = tp.partition_move.launches, tc.compact_by_mask.launches
    tp.partition_move(*args)
    tc.compact_by_mask(args[0], args[1], keep, 3000)
    assert (tp.partition_move.launches, tc.compact_by_mask.launches) == \
        (b0, c0)
    cargs = [a.to(cuda_device) for a in args]
    tp.partition_move(*cargs)
    tc.compact_by_mask(cargs[0], cargs[1], keep.to(cuda_device), 3000)
    assert (tp.partition_move.launches, tc.compact_by_mask.launches) == \
        (b0 + 1, c0 + 1)


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


@pytest.mark.parametrize("n,F,B,C,K,nb,leaves", [
    (65_536, 6, 256, 3, 1, 16, "lane0"),   # K = 1, every row in lane 0
    (65_536, 5, 256, 3, 8, 1, "neg"),      # nb = 1: 256 tiles a feature
    (65_536, 5, 256, 3, 8, 8, "neg"),
    (65_536, 5, 256, 3, 8, 48, "neg"),     # nb does not divide B
    (65_536, 5, 256, 3, 32, 512, "neg"),   # nb > B: one tile a feature
    (65_536, 4, 256, 8, 32, 512, "neg"),   # a tile capped by shared memory
    (20_000, 4, 255, 1, 5, 16, "neg"),     # B = 255, C = 1
    (20_000, 4, 63, 8, 32, 16, "neg"),     # B = 63, C = 8
    (4099, 3, 64, 3, 6, 16, "neg"),        # n % 4 != 0: the scalar path
    (1_048_580, 4, 256, 3, 32, 32, "neg"),  # n >= 2^20
])
def test_nibble_cluster_kernel(cuda_device, n, F, B, C, K, nb, leaves):
    """The cluster form of the nibble probe against the plain version:
    within the f32 tolerance on normal values and bit-equal on exact-sum
    values; rows with leaf id -1 match no lane and -1 lanes are zero."""
    rng = np.random.default_rng(n + nb + C)
    bins = torch.from_numpy(rng.integers(0, B, size=(F, n)).astype(np.uint8))
    if leaves == "lane0":
        leaf = torch.zeros(n, dtype=torch.int32)
        ids = torch.zeros(1, dtype=torch.int32)
    else:
        leaf = torch.from_numpy(rng.integers(-1, K + 2, size=n)
                                .astype(np.int32))
        ids = np.arange(K, dtype=np.int32)
        ids[1::4] = -1
        ids = torch.from_numpy(ids)
    cargs = [bins.to(cuda_device), None, leaf.to(cuda_device),
             ids.to(cuda_device)]
    plan = hp.nibble_plan(cargs[0], torch.zeros((C, n), device=cuda_device),
                          cargs[2], cargs[3], num_bins=B, nb=nb)
    assert 1 <= plan["cluster"] <= 16 and plan["clusters"] >= 1
    # a tile's bins: nb, capped at B and at what fits in the shared memory
    # beside the lane and bin tables (232,448 - 8,832 bytes) and a stage
    # of 1024 rows (mask, bf16 values, 4 bytes of bins)
    assert plan["w"] == min(nb, B, (223_616 - 1024 * (8 + 2 * C))
                            // (K * C * 4))
    for vals, exact in ((torch.from_numpy(rng.normal(size=(C, n))
                                          .astype(np.float32)), False),
                        (_exact_f32_vals(rng, C, n), True)):
        plain = th.multi_leaf_histogram_plain(bins, vals, leaf, ids,
                                              num_bins=B)
        cargs[1] = vals.to(cuda_device)
        before = hp.hist_probe_nibble.launches
        out = hp.hist_probe_nibble(*cargs, num_bins=B, nb=nb).cpu()
        assert hp.hist_probe_nibble.launches == before + 1
        if exact:
            assert torch.equal(out, plain)
        else:
            vb = vals.to(torch.bfloat16).float()
            tol = 2.0 ** -20 * vb.abs().sum(1)
            assert bool(((out - plain).abs() <= tol).all())
        dead = (ids < 0).nonzero().flatten()
        assert not out[dead].any()


# (n, F, B, C, K, leaf ids, lane ids, skewed bins): every row in lane 0 at
# K = 1, 16, 32; 32 live lanes (feature blocks that re-read the rows);
# repeated, negative and large ids; channels 1 / 3 / 8; bins 1 / 63 / 255
# / 256; F = 1 and 28; n = 1, n % 4 != 0, below one CTA's share and past
# 2^21; 90% of each feature's rows in one bin
PROBE_1D_CASES = {
    "lane0_k1": (65_536, 28, 256, 3, 1, "zeros", "arange", False),
    "lane0_k16": (65_536, 28, 256, 3, 16, "zeros", "arange", False),
    "lane0_k32": (65_536, 28, 256, 3, 32, "zeros", "arange", False),
    "uniform_k32": (65_536, 28, 256, 3, 32, "uniform", "arange", False),
    "repeated_ids": (20_000, 5, 64, 3, 6, "uniform", "repeated", False),
    "negative_ids": (20_000, 5, 64, 3, 12, "negative", "negative", False),
    "ids_past_table": (20_000, 4, 32, 2, 6, "big", "big", False),
    "c1_b256": (30_000, 6, 256, 1, 8, "uniform", "arange", False),
    "c8_b63": (30_000, 6, 63, 8, 32, "negative", "negative", False),
    "c8_b256": (30_000, 3, 256, 8, 8, "uniform", "arange", False),
    "b1": (10_000, 3, 1, 3, 4, "uniform", "arange", False),
    "b255": (10_000, 3, 255, 3, 4, "uniform", "negative", False),
    "f1": (50_000, 1, 256, 3, 16, "negative", "negative", False),
    "n1": (1, 28, 256, 3, 4, "zeros", "arange", False),
    "n_misaligned": (4099, 5, 64, 4, 6, "negative", "negative", False),
    "n_below_share": (1000, 2, 64, 3, 5, "uniform", "arange", False),
    "n_past_2e21": (2_097_164, 3, 256, 3, 8, "uniform", "arange", False),
    "skewed_lane0": (65_536, 28, 256, 3, 16, "zeros", "arange", True),
    "skewed_k32": (65_536, 8, 256, 3, 32, "uniform", "arange", True),
}


def _probe_1d_case(name):
    n, F, B, C, K, leaves, lanes, skewed = PROBE_1D_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    bins = rng.integers(0, B, size=(F, n)).astype(np.uint8)
    if skewed:
        bins[rng.random((F, n)) < 0.9] = 17
    ids = np.arange(K, dtype=np.int32)
    if lanes == "repeated":
        ids = np.array([3, 3, 5, 3, -1, 5], np.int32)[:K]
    elif lanes == "negative":
        ids[1::4] = -1
    elif lanes == "big":
        ids = np.array([0, 5000, 2047, 2048, 70_000, -1], np.int32)[:K]
    if leaves == "zeros":
        leaf = np.zeros(n, np.int32)
    elif leaves == "big":
        leaf = rng.choice(np.array([0, 1, 5000, 2047, 2048, 70_000, 4999,
                                    -1], np.int32), size=n)
    else:
        lo = -1 if leaves == "negative" else 0
        leaf = rng.integers(lo, K + (2 if lo else 0), size=n).astype(np.int32)
    return [torch.from_numpy(a) for a in (bins, leaf, ids)], rng, B, C


@pytest.mark.parametrize("name", list(PROBE_1D_CASES))
def test_probe_1d_kernel(cuda_device, name):
    """The 1-D probe against the plain version: within the f32 tolerance
    on normal values and bit-equal on exact-sum values, one launch a
    call; rows with a negative leaf id match no lane, -1 lanes and lanes
    that no row names are zero, and a repeated id gives each of its lanes
    the same sums."""
    (bins, leaf, ids), rng, B, C = _probe_1d_case(name)
    n = bins.shape[1]
    cargs = [bins.to(cuda_device), None, leaf.to(cuda_device),
             ids.to(cuda_device)]
    for vals, exact in ((torch.from_numpy(rng.normal(size=(C, n))
                                          .astype(np.float32)), False),
                        (_exact_f32_vals(rng, C, n), True)):
        plain = th.multi_leaf_histogram_plain(bins, vals, leaf, ids,
                                              num_bins=B)
        cargs[1] = vals.to(cuda_device)
        before = hp.hist_probe_1d.launches
        out = hp.hist_probe_1d(*cargs, num_bins=B).cpu()
        assert hp.hist_probe_1d.launches == before + 1
        if exact:
            assert torch.equal(out, plain)
        else:
            tol = 2.0 ** -20 * vals.to(torch.bfloat16).float().abs().sum(1)
            assert bool(((out - plain).abs() <= tol).all())
        assert not out[(ids < 0).nonzero().flatten()].any()


def test_probe_1d_launches_in_a_row(cuda_device):
    """Three launches in a row on one stream, each with another number of
    live lanes and so another layout of the cached scratch: each equals
    its plain version bit for bit (exact-sum values), so no partial of
    one launch leaks into the next."""
    calls = []
    for name in ("uniform_k32", "lane0_k16", "negative_ids"):
        (bins, leaf, ids), rng, B, C = _probe_1d_case(name)
        vals = _exact_f32_vals(rng, C, bins.shape[1])
        calls.append((th.multi_leaf_histogram_plain(bins, vals, leaf, ids,
                                                    num_bins=B),
                      hp.hist_probe_1d(*[a.to(cuda_device) for a in
                                         (bins, vals, leaf, ids)],
                                       num_bins=B)))
    for plain, out in calls:
        assert torch.equal(out.cpu(), plain)


def test_probe_1d_plan(cuda_device):
    """The passes the kernel picks. At one live lane (the TPU probe's
    shape: 16 lanes, every row in lane 0) each slot tile gets 32 replicas
    (adds free of bank conflicts) and a pass takes the features that fit
    with them; at 32 live lanes a pass takes as many features as fit, one
    replica each, and every feature block is one more read of the rows."""
    (bins, leaf, ids), rng, B, C = _probe_1d_case("lane0_k16")
    vals = torch.zeros((C, bins.shape[1]), device=cuda_device)
    args = [bins.to(cuda_device), vals, leaf.to(cuda_device),
            ids.to(cuda_device)]
    one = hp.probe_1d_plan(*args, num_bins=B)
    assert one["replicas"] == 32
    assert one["features_per_pass"] == min(28, one["tiles"] // 32) >= 1
    assert one["row_reads"] == -(-28 // one["features_per_pass"])
    args[2] = torch.arange(bins.shape[1], device=cuda_device,
                           dtype=torch.int32) % 32
    args[3] = torch.arange(32, device=cuda_device, dtype=torch.int32)
    many = hp.probe_1d_plan(*args, num_bins=B)
    assert many["features_per_pass"] == one["tiles"] // 32
    assert many["replicas"] == 1
    assert many["row_reads"] == -(-28 // many["features_per_pass"]) > 1
    assert 1 <= many["ctas_with_rows"] <= many["ctas"]


class _SameDraws:
    """The same uniforms on every device: numpy's generator seeded with
    (iteration, stream), moved to ``device``."""

    def __init__(self, device):
        self.device = device

    def _u(self, iteration, n, stream):
        u = np.random.default_rng([iteration, stream]).random(
            n, dtype=np.float32)
        return torch.from_numpy(u).to(self.device)

    def goss_uniform(self, iteration, n):
        return self._u(iteration, n, 0)

    def quant_uniforms(self, iteration, n, k=0):
        return (self._u(iteration, n, 1 + 2 * k) - 0.5,
                self._u(iteration, n, 2 + 2 * k) - 0.5)


# path -> (training rows, rounds, params); GOSS starts at iteration 1/lr = 3
# and compacts all classes' gradients ([2K + 2, n]) in one launch of B
MULTICLASS_PATHS = {
    "masked": (5000, 4, {}),
    "goss": (16_000, 6, {"data_sample_strategy": "goss", "top_rate": 0.1,
                         "other_rate": 0.05, "tpu_goss_compact": True,
                         "learning_rate": 0.3}),
}


@pytest.mark.parametrize("path", list(MULTICLASS_PATHS))
def test_multiclass_training_card_matches_cpu(cuda_device, path):
    """Multiclass softmax (3 trees an iteration) trained on the card and
    on the CPU from the same data and draws, quantized gradients without
    stochastic rounding, on the masked path and under GOSS with the
    compacted buffer: identical split lines, predictions within 1e-5."""
    import lightgbm_tpu_torch as lgt
    n, rounds, extra = MULTICLASS_PATHS[path]
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n + 1000, 12))
    y = np.argmax(X[:, :3] + rng.normal(scale=0.7, size=(n + 1000, 3)),
                  axis=1).astype(np.float64)
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "num_leaves")
    out = {}
    compact0 = tc.compact_by_mask.launches
    for dev in ("cuda", "cpu"):
        bst = lgt.train(dict({"objective": "multiclass", "num_class": 3,
                              "num_leaves": 15, "tpu_leaf_batch": 4,
                              "use_quantized_grad": True,
                              "stochastic_rounding": False, "verbosity": -1,
                              "device_type": dev}, **extra),
                        lgt.Dataset(X[:n], label=y[:n]),
                        num_boost_round=rounds, noise=_SameDraws(dev))
        assert bst.engine.use_goss_compact == (path == "goss")
        out[dev] = ([ln for ln in bst.model_to_string().splitlines()
                     if ln.split("=", 1)[0] in keys], bst.predict(X[n:]))
    if path == "goss":
        assert tc.compact_by_mask.launches - compact0 == rounds - 3
    assert len(out["cuda"][0]) == len(keys) * 3 * rounds
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1].shape == (1000, 3)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-5)


def _off_by_the_reciprocal(levels, rng):
    """A float32 value x > 1 whose x * (1 / levels) is not x / levels."""
    recip = np.float32(1.0) / np.float32(levels)
    while True:
        x = np.float32(rng.uniform(1.0, 2.0))
        if x * recip != x / np.float32(levels):
            return x


@pytest.mark.parametrize("levels", [3, 15])
def test_quantize_on_the_card_equals_the_cpu(cuda_device, levels):
    """The gradient quantizer gives the same levels and scales on the card
    as on the CPU, bit for bit, where max |g| and max h are values whose
    product with the reciprocal of the level count is not their quotient
    (CUDA divides a tensor by a Python number as such a product; the
    CPU and the JAX package take the quotient)."""
    from lightgbm_tpu_torch.boosting.gbdt import quantize
    rng = np.random.default_rng(levels)
    n = 4096
    g = rng.uniform(-1.0, 1.0, size=n).astype(np.float32)
    h = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
    g[7] = -_off_by_the_reciprocal(levels, rng)
    h[11] = _off_by_the_reciprocal(levels, rng)
    count = (rng.random(n) < 0.9).astype(np.float32)
    draws = [rng.uniform(-0.5, 0.5, size=n).astype(np.float32)
             for _ in range(2)]
    out = {}
    for dev in ("cuda", "cpu"):
        t = [torch.from_numpy(a).to(dev) for a in (g, h, count, *draws)]
        out[dev] = quantize(t[0], t[1], t[2], levels, levels, (t[3], t[4]))
    # the inputs catch a division by the Python number on the card
    gmax = torch.tensor(-g[7], device=cuda_device)
    assert float(gmax / levels) != float(np.float32(-g[7])
                                         / np.float32(levels))
    assert float(out["cpu"][2][0]) == float(np.float32(-g[7])
                                            / np.float32(levels))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a.cpu(), b)


def _guard_data(n, seed=7):
    """Guard-shaped rows (``bench.py::synth_guard`` with a 3-way column
    and 10% NaN in the categorical columns 10, 11, 12) and a 0/1 label."""
    rng = np.random.default_rng(seed)
    Xn = rng.normal(size=(n, 10))
    cats = [rng.integers(0, k, size=n) for k in (12, 40, 3)]
    logit = (Xn[:, 0] * Xn[:, 1] + 0.9 * Xn[:, 2] * Xn[:, 3]
             + rng.normal(size=12)[cats[0]] * 1.2
             + rng.normal(size=40)[cats[1]] * 0.8
             + np.array([0.5, -0.6, 0.2])[cats[2]])
    Xn[rng.uniform(size=(n, 10)) < 0.1 * (np.arange(10) < 5)] = np.nan
    y = (logit + rng.normal(size=n) > 0).astype(np.float64)
    X = np.column_stack([Xn] + cats).astype(np.float64)
    for j in (10, 11, 12):
        X[rng.uniform(size=n) < 0.1, j] = np.nan
    return X, y


# path -> (training rows, params); GOSS starts at iteration 1/lr = 3
CATEGORICAL_PATHS = {
    "masked": (5000, {}),
    "partition": (5000, {"tpu_hist_partition": "true"}),
    "goss": (16_000, {"data_sample_strategy": "goss", "top_rate": 0.1,
                      "other_rate": 0.05, "tpu_goss_compact": True}),
}


@pytest.mark.parametrize("path", list(CATEGORICAL_PATHS))
def test_categorical_training_card_matches_cpu(cuda_device, path):
    """Binary training with three categorical columns on the card and on
    the CPU from the same data and draws: identical split lines (with
    categorical splits), predictions within 1e-5, on the masked path, the
    row partition (the move B′ routes rows by bitset) and GOSS with the
    compacted buffer."""
    import lightgbm_tpu_torch as lgt
    n, extra = CATEGORICAL_PATHS[path]
    X, y = _guard_data(n + 1000)
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "num_leaves")
    out = {}
    move0 = tp.partition_move.launches
    for dev in ("cuda", "cpu"):
        bst = lgt.train(dict({"objective": "binary", "num_leaves": 15,
                              "learning_rate": 0.3, "tpu_leaf_batch": 4,
                              "use_quantized_grad": True,
                              "stochastic_rounding": False,
                              "min_data_per_group": 50, "verbosity": -1,
                              "device_type": dev}, **extra),
                        lgt.Dataset(X[:n], label=y[:n],
                                    categorical_feature=[10, 11, 12]),
                        num_boost_round=6, noise=_SameDraws(dev))
        assert bst.engine.has_categorical
        out[dev] = ([ln for ln in bst.model_to_string().splitlines()
                     if ln.split("=", 1)[0] in keys], bst.predict(X[n:]))
    if path == "partition":
        assert tp.partition_move.launches > move0
    cat_nodes = sum(int(v) & 1 for ln in out["cpu"][0]
                    if ln.startswith("decision_type=")
                    for v in ln.split("=", 1)[1].split())
    assert cat_nodes > 0
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-5)


def test_bitset_routing_on_the_card_equals_the_cpu(cuda_device):
    """``_apply_splits`` and ``forest_predict_binned`` with categorical
    nodes (bitsets with bit 31 set, bin 0 never in a set) give the same
    leaf ids on the card as on the CPU."""
    from lightgbm_tpu_torch.learner.serial import _apply_splits
    from lightgbm_tpu_torch.ops.predict import forest_predict_binned
    rng = np.random.default_rng(1)
    n, F, B, Kb, T, Ln = 50_000, 6, 64, 4, 3, 7
    W = B // 32
    nb = np.full(F, B, np.int32)
    bins = rng.integers(0, B, size=(n, F)).astype(np.uint8)
    words = rng.integers(0, 2 ** 32, size=(Kb, W), dtype=np.int64)
    words[:, 0] &= ~1                                 # bin 0 misses
    words[:, -1] |= 1 << 31
    cpu = dict(
        leaf=rng.integers(0, 8, size=n).astype(np.int32),
        lane=np.array([0, -1, 1, 2, -1, 3, -1, -1, -1], np.int64),
        feat=rng.integers(0, F, size=Kb).astype(np.int32),
        thr=rng.integers(0, B, size=Kb).astype(np.int32),
        dl=rng.random(Kb) < 0.5, new=np.arange(8, 8 + Kb, dtype=np.int32),
        cat=np.array([True, False, True, True]), bitset=words)
    fb = rng.integers(0, 2 ** 32, size=(T, Ln, W), dtype=np.int64)
    fb[..., 0] &= ~1
    lc = np.array([1, 3, -3, 5, -5, -6, -7])
    rc = np.array([2, -2, 4, -4, 6, -1, -8])
    forest = dict(num_leaves=np.full(T, 8, np.int32),
                  split_feature=rng.integers(0, F, size=(T, Ln))
                  .astype(np.int32),
                  threshold_bin=rng.integers(0, B, size=(T, Ln))
                  .astype(np.int32),
                  default_left=rng.random((T, Ln)) < 0.5,
                  left_child=np.tile(lc, (T, 1)).astype(np.int32),
                  right_child=np.tile(rc, (T, 1)).astype(np.int32),
                  leaf_value=rng.normal(size=(T, 8)).astype(np.float32),
                  is_cat=rng.random((T, Ln)) < 0.6, cat_bitset=fb)
    res = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in cpu.items()}
        b = torch.from_numpy(bins).to(dev)
        leaf = _apply_splits(t["leaf"], b.T.contiguous(), t["lane"],
                             t["feat"], t["thr"], t["dl"], t["new"],
                             torch.from_numpy(nb).to(dev),
                             torch.zeros(F, dtype=torch.bool, device=dev),
                             cat=t["cat"], bitset=t["bitset"])
        fs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in forest.items()}
        raw, leaves = forest_predict_binned(
            fs, b, torch.from_numpy(nb).to(dev),
            torch.zeros(F, dtype=torch.bool, device=dev), 4)
        res[dev] = (leaf.cpu(), raw.cpu(), leaves.cpu())
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)
    moved = res["cpu"][0] != torch.from_numpy(cpu["leaf"])
    assert 0 < int(moved.sum()) < n


# ---- EFB and sparse input ---------------------------------------------------
def _bundle_data(n, seed=0, flip=0.0):
    """3 normal columns, 4 groups of 8 one-hot indicators (a ninth state:
    the group all zero; ``flip`` of the entries set to 1) and 2 groups of
    4 sparse continuous columns, one of a group non-zero on 2/3 of the
    rows (the data of ``tests/test_torch_bundling.py``)."""
    rng = np.random.default_rng(seed)
    groups = [rng.normal(size=(n, 3))]
    for _ in range(4):
        sel = rng.integers(0, 9, size=n)
        m = (sel[:, None] == np.arange(8)[None, :]).astype(np.float64)
        if flip:
            m[rng.random(m.shape) < flip] = 1.0
        groups.append(m)
    for _ in range(2):
        sel = rng.integers(0, 6, size=n)
        v = np.round(rng.lognormal(size=(n, 4)) * 4) / 4
        v *= np.where(rng.random((n, 4)) < 0.3, -1.0, 1.0)
        groups.append(np.where(sel[:, None] == np.arange(4)[None, :], v,
                               0.0))
    X = np.hstack(groups)
    logit = X[:, 0] + X[:, 3] - X[:, 12] + 0.5 * X[:, 35] - 0.7 * X[:, 40]
    return X, (logit + rng.normal(size=n) > 0).astype(np.float64)


# case -> (flip, params); GOSS starts at iteration 1/lr = 2
EFB_CASES = {
    "masked": (0.0, {}),
    "goss": (0.0, {"data_sample_strategy": "goss", "top_rate": 0.2,
                   "other_rate": 0.1}),
    "partition": (0.0, {"tpu_hist_partition": "true"}),
    "exact": (0.0, {"use_quantized_grad": False}),
    "conflicts_0.2": (0.03, {"max_conflict_rate": 0.2,
                             "tpu_hist_partition": "true"}),
    "csr_input": (0.0, {}),
}


@pytest.mark.parametrize("case", list(EFB_CASES))
def test_efb_training_card_matches_cpu(cuda_device, case):
    """Bundled training on the card and on the CPU from the same data and
    draws: the same bundles, identical split lines (on exact gradients
    kernel A adds floats in another order than the plain version, so
    there the lines may part only where every tree keeps the same rows in
    each leaf), predictions within 1e-5; kernel A scans the physical
    columns, B never launches (GOSS stays masked under EFB) and B′ moves
    the physical columns under the partition."""
    import scipy.sparse as sp

    import lightgbm_tpu_torch as lgt
    flip, extra = EFB_CASES[case]
    n = 4000
    X, y = _bundle_data(n + 1000, flip=flip)
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "num_leaves")
    out = {}
    launches0 = (th.multi_leaf_histogram.launches,
                 tc.compact_by_mask.launches, tp.partition_move.launches)
    for dev in ("cuda", "cpu"):
        Xt = sp.csr_matrix(X[:n]) if case == "csr_input" else X[:n]
        bst = lgt.train(dict({"objective": "binary", "num_leaves": 15,
                              "learning_rate": 0.5, "tpu_leaf_batch": 4,
                              "use_quantized_grad": True,
                              "stochastic_rounding": False, "verbosity": -1,
                              "device_type": dev}, **extra),
                        lgt.Dataset(Xt, label=y[:n]), num_boost_round=5,
                        noise=_SameDraws(dev))
        eng = bst.engine
        assert eng.has_bundles and not eng.use_goss_compact
        assert eng.data.bins_t.shape[0] == eng.bundle_plan.n_phys < 43
        out[dev] = ([ln for ln in bst.model_to_string().splitlines()
                     if ln.split("=", 1)[0] in keys], bst.predict(X[n:]),
                    bst.predict(X[:n], pred_leaf=True),
                    eng.bundle_plan.bundles)
    assert th.multi_leaf_histogram.launches > launches0[0]
    assert tc.compact_by_mask.launches == launches0[1]
    assert (tp.partition_move.launches > launches0[2]) \
        == ("tpu_hist_partition" in extra)
    assert out["cuda"][3] == out["cpu"][3]
    if out["cuda"][0] != out["cpu"][0]:
        assert case == "exact"
        for a, b in zip(out["cuda"][2].T, out["cpu"][2].T):
            pairs = set(zip(a.tolist(), b.tolist()))
            assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-5)


def test_expand_and_bundle_routing_on_the_card_equal_the_cpu(cuda_device):
    """``expand_hist`` (the default-bin residual summed in XLA's CPU
    order, ``sum_bins``) and ``_apply_splits`` over a bundled matrix give
    the same bits on the card as on the CPU."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.io.bundling import (apply_bundles, find_bundles,
                                                plan_bundles)
    from lightgbm_tpu_torch.learner.serial import (BundleMaps, _apply_splits,
                                                   expand_hist)
    X, _ = _bundle_data(20_000, seed=3, flip=0.01)
    ds = lgt.Dataset(X, label=np.zeros(len(X))).construct()
    nb = ds.feature_num_bins()
    ms = [ds.bin_mappers[f] for f in ds.used_features]
    eligible = np.array([m.missing_type == "none" for m in ms])
    default = np.array([m.value_to_bin(0.0) for m in ms], np.int32)
    plan = plan_bundles(nb, default, find_bundles(
        ds.binned, nb, eligible, default, max_conflict_rate=0.2))
    phys = apply_bundles(ds.binned, plan)
    B, F, Kb = 256, len(nb), 6
    rng = np.random.default_rng(0)
    h = (rng.normal(size=(8, plan.n_phys, B, 3)) * 50).astype(np.float32)
    tot = (rng.normal(size=(8, 3)) * 1e3).astype(np.float32)
    feat = np.array([35, 3, 12, 40, 0, 20], np.int32)
    assert plan.bundled[feat[:4]].all()
    leaf0 = torch.from_numpy((np.arange(len(X)) % Kb).astype(np.int32))
    lane = torch.arange(Kb + 1)
    lane[Kb] = -1
    res = {}
    for dev in ("cuda", "cpu"):
        bm = BundleMaps.from_plan(plan, nb, B, torch.device(dev))
        ex = expand_hist(torch.from_numpy(h).to(dev),
                         torch.from_numpy(tot).to(dev), bm)
        leaf = _apply_splits(
            leaf0.to(dev), torch.from_numpy(phys.T.copy()).to(dev),
            lane.to(dev), torch.from_numpy(feat).to(dev),
            torch.from_numpy((nb[feat] // 2).astype(np.int32)).to(dev),
            torch.zeros(Kb, dtype=torch.bool, device=dev),
            torch.arange(Kb, 2 * Kb, dtype=torch.int32, device=dev),
            torch.from_numpy(nb).to(dev),
            torch.zeros(F, dtype=torch.bool, device=dev), bundle=bm)
        res[dev] = (ex.cpu(), leaf.cpu())
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)
    moved = res["cpu"][1] != leaf0
    assert 0 < int(moved.sum()) < len(X)


# ---- ranking ----------------------------------------------------------------
def _rank_inputs(seed=0, n_queries=300):
    """Uneven queries (1 to 200 documents, one of one, one all zero),
    relevance 0-4, scores with ties, positions 0-11."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 201, size=n_queries)
    counts[4] = 1
    n = int(counts.sum())
    label = rng.integers(0, 5, size=n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(counts)])
    label[qb[7]:qb[8]] = 0
    score = rng.normal(size=n).astype(np.float32)
    tied = np.arange(7, n - 1, 7)
    score[tied] = score[tied + 1]
    return qb, label, score, rng.integers(0, 12, size=n)


RANKING_CASES = {
    "lambdarank": ({"objective": "lambdarank"}, False),
    "rank_xendcg": ({"objective": "rank_xendcg"}, False),
    "position": ({"objective": "lambdarank"}, True),
    "unbiased": ({"objective": "lambdarank", "lambdarank_unbiased": True,
                  "lambdarank_bias_p_norm": 0.5}, False),
}


def _rank_gradients(case, dev, iterations=3):
    """The case's gradients (and propensities) over ``iterations`` steps
    on ``dev``, from the same inputs; the queries in chunks of 50."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective import create_objective
    params, use_pos = RANKING_CASES[case]
    qb, label, score, pos = _rank_inputs()
    obj = create_objective(Config(dict(params)))
    obj.prepare(label, None)
    obj.setup_queries(qb, len(label), position=pos if use_pos else None,
                      device=dev)
    Q, M = obj.query_shape
    obj.pair_chunk_elems = 50 * min(30, M) * M
    s = torch.from_numpy(score).to(dev)
    y = torch.from_numpy(label.astype(np.float32)).to(dev)
    state = obj.init_pos_state() if obj.has_pos_state else None
    out = []
    for it in range(iterations):
        kw = {}
        if obj.needs_rng:
            kw["gammas"] = torch.from_numpy(np.random.default_rng(it).random(
                (Q, M), dtype=np.float32)).to(dev)
        elif state is not None:
            kw["pos_state"] = state
        res = obj.get_gradients(s, y, None, **kw)
        if state is not None:
            state = res[2]
        out.append([r.cpu() for r in res])
        s = s - 0.5 * res[0]
    return out


@pytest.mark.parametrize("case", list(RANKING_CASES))
def test_ranking_gradients_on_the_card_equal_the_cpu(cuda_device, case):
    """The pair sums are fixed trees of float32 adds and the
    transcendental functions run in float64, so the card gives the CPU's
    bits, three iterations deep (the debiased cases thread their
    propensities)."""
    for a, b in zip(_rank_gradients(case, cuda_device),
                    _rank_gradients(case, "cpu")):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_debiased_gradients_are_deterministic_on_the_card(cuda_device):
    """The position costs add in a fixed order (no atomics), so two card
    runs give the same bits."""
    for case in ("position", "unbiased"):
        for a, b in zip(_rank_gradients(case, cuda_device),
                        _rank_gradients(case, cuda_device)):
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def test_card_sort_orders_ties_by_index(cuda_device):
    """``torch.sort(-s, stable=True)`` on the card: ties by index, -inf
    padding last, as on the CPU (and as the JAX package's stable
    argsort)."""
    rng = np.random.default_rng(3)
    s = rng.integers(0, 4, size=(64, 300)).astype(np.float32)
    s[:, 250:] = -np.inf
    s[5] = -np.inf
    s = torch.from_numpy(s)
    got = torch.sort(-s.to(cuda_device), dim=1, stable=True).indices.cpu()
    want = torch.sort(-s, dim=1, stable=True).indices
    assert torch.equal(got, want)
    key = (-s).numpy()
    np.testing.assert_array_equal(
        want.numpy(), np.argsort(key, axis=1, kind="stable"))


def _sigmoid_inputs():
    """10^6 float32 inputs: normal draws at three scales, a dense grid
    over [-100, 100], and the edges (±inf, NaN, ±0, subnormals, the
    clamp bounds, the overflow and underflow thresholds)."""
    rng = np.random.default_rng(0)
    draws = np.concatenate([rng.normal(size=200_000) * s
                            for s in (0.5, 2.0, 6.0)])
    edges = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45,
                      1e-40, -1e-40, -87.8, 88.8, 88.72, 88.73, -87.33,
                      -87.34, 3.4e38, -3.4e38])
    grid = np.linspace(-100.0, 100.0, 400_000 - len(edges))
    return torch.from_numpy(np.concatenate([draws, grid, edges])
                            .astype(np.float32))


def test_xla_exp_and_sigmoid_on_the_card_equal_the_cpu(cuda_device):
    """``_exp_xla`` and ``_sigmoid_xla`` are correctly rounded IEEE steps
    (float64 products and sums, floor, a power-of-two scale from the
    exponent bits), so the card gives the CPU's bits, and with them the
    binary objective's gradients. A NaN input gives NaN on both devices;
    its payload bits are not held."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objective import (_exp_xla, _sigmoid_xla,
                                              create_objective)
    x = _sigmoid_inputs()
    for fn in (_exp_xla, _sigmoid_xla):
        got = fn(x.to(cuda_device)).cpu()
        want = fn(x)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        bad = (got.view(torch.int32) != want.view(torch.int32)) & ~nan
        assert not bad.any(), (fn.__name__, x[bad][:8].tolist(),
                               got[bad][:8].tolist(), want[bad][:8].tolist())
    obj = create_objective(Config({"objective": "binary", "sigmoid": 1.5,
                                   "scale_pos_weight": 2.0}))
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.normal(scale=3, size=100_000)
                         .astype(np.float32))
    y = torch.from_numpy((rng.random(100_000) < 0.4).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.2, 3, size=100_000)
                         .astype(np.float32))
    for a, b in zip(obj.get_gradients(s.to(cuda_device), y.to(cuda_device),
                                      w.to(cuda_device)),
                    obj.get_gradients(s, y, w)):
        assert torch.equal(a.cpu(), b)


def test_dart_dropped_tree_predict_on_the_card_equals_the_cpu(cuda_device):
    """DART's dropped trees (iterations out of order, K = 3 trees each)
    traversed on the card and on the CPU: the per-class sums run in the
    stack's order, so the bits agree."""
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops.predict import forest_predict_binned
    rng = np.random.default_rng(2)
    X = rng.normal(size=(4000, 8))
    y = np.argmax(X[:, :3] + rng.normal(size=(4000, 3)), axis=1)
    bst = lgt.train({"objective": "multiclass", "num_class": 3,
                     "boosting": "dart", "num_leaves": 15,
                     "learning_rate": 0.3, "drop_rate": 0.5,
                     "use_quantized_grad": True, "verbosity": -1,
                     "device_type": "cpu"},
                    lgt.Dataset(X, label=y.astype(np.float64)),
                    num_boost_round=8)
    eng = bst.engine
    assert eng.drop_iterations > 0
    idx = [i * 3 + c for i in (6, 1, 4) for c in range(3)]
    stacked, cls, depth = eng._stack_model_list(idx)
    bins = eng._logical_bins()
    want, wl = forest_predict_binned(stacked, bins, eng.feat_num_bin,
                                     eng.feat_has_nan, depth, 3,
                                     class_index=cls)
    dev = {k: v.to(cuda_device) for k, v in stacked.items()}
    got, gl = forest_predict_binned(dev, bins.to(cuda_device),
                                    eng.feat_num_bin.to(cuda_device),
                                    eng.feat_has_nan.to(cuda_device), depth,
                                    3, class_index=cls)
    assert torch.equal(gl.cpu(), wl)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_dart_monotone_training_card_matches_cpu(cuda_device):
    """DART under GOSS with a monotone constraint (intermediate method,
    leaf batch 8) on the card and on the CPU from the same draws: the
    same drops, identical split lines, predictions within 1e-5."""
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(4)
    n = 4000
    X = rng.normal(size=(n + 1000, 10))
    y = 2 * X[:, 0] + np.abs(X[:, 1]) + rng.normal(scale=0.5, size=n + 1000)
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "num_leaves")
    out = {}
    for dev in ("cuda", "cpu"):
        bst = lgt.train({"objective": "regression", "boosting": "dart",
                         "data_sample_strategy": "goss", "top_rate": 0.2,
                         "other_rate": 0.1, "num_leaves": 15,
                         "learning_rate": 0.5, "drop_rate": 0.5,
                         "skip_drop": 0.2, "tpu_leaf_batch": 8,
                         "monotone_constraints": [1] + [0] * 9,
                         "monotone_constraints_method": "intermediate",
                         "use_quantized_grad": True,
                         "stochastic_rounding": False, "verbosity": -1,
                         "device_type": dev},
                        lgt.Dataset(X[:n], label=y[:n]), num_boost_round=6,
                        noise=_SameDraws(dev))
        out[dev] = ([ln for ln in bst.model_to_string().splitlines()
                     if ln.split("=", 1)[0] in keys], bst.predict(X[n:]),
                    bst.engine.drop_iterations)
    assert out["cuda"][2] == out["cpu"][2] > 0
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-5)


def test_device_ingest_on_the_card_equals_the_native_host_pass(cuda_device):
    """Device ingest at about 300k x 200 with ragged chunks (the width's
    default chunk rows, and 4,096-row chunks with a 1,000-row tail) and two
    categorical columns (NaN, unseen and negative ids among them), NaN,
    +-inf and +-0: bins and bins_t byte-equal to the native host pass; the
    engine adopts them."""
    from lightgbm_tpu_torch.ops import ingest
    import lightgbm_tpu_torch as lgt
    rng = np.random.default_rng(7)
    n, F = 300 * 1024 + 1000, 200
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random((n, F)) < 0.02] = np.nan
    X[:50, 3] = [np.inf, -np.inf, 0.0, -0.0, 1e-40] * 10
    for c in (17, 150):
        X[:, c] = rng.integers(0, 300, size=n)
        X[rng.random(n) < 0.01, c] = 9999.0
        X[rng.random(n) < 0.01, c] = -4.0
    y = (np.nan_to_num(X[:, 0]) > 0).astype(np.float64)
    params = {"device_type": "cuda"}
    host = lgt.Dataset(X, label=y, categorical_feature=[17, 150],
                       params=dict(params, tpu_ingest_device="false"))
    host.construct()
    dev = lgt.Dataset(X, label=y, categorical_feature=[17, 150],
                      params=dict(params, tpu_ingest_device="auto"))
    dev.construct()
    ing = dev.device_ingested()
    assert ing is not None and ing.bins.is_cuda
    R = ingest.chunk_rows_for(F)
    assert n % R and ing.chunks == -(-n // R) and ing.assign_ms > 0
    want = torch.from_numpy(host.binned).to(cuda_device)
    assert torch.equal(ing.bins, want)
    assert torch.equal(ing.bins_t, want.T.contiguous())
    small = ingest.device_ingest(X, host.bin_mappers, host.used_features,
                                 cuda_device, chunk_rows=4096)
    assert small.chunks == -(-n // 4096)
    assert torch.equal(small.bins, want)
    assert torch.equal(small.bins_t, want.T.contiguous())
    del small
    bst = lgt.Booster(params={"objective": "binary", "num_leaves": 15,
                              "verbosity": -1, "device_type": "cuda"},
                      train_set=dev)
    assert bst.engine.data.bins_t.data_ptr() == ing.bins_t.data_ptr()
    bst.update()
    assert dev._binned is None
    np.testing.assert_array_equal(dev.binned, host.binned)


# ---- wide bins: uint16 bin ids ---------------------------------------------
@pytest.mark.parametrize("int_mode", [True, False])
@pytest.mark.parametrize("n,F,B,K", [
    (1_000_000, 28, 1024, 32),     # two lane groups of 18 lanes
    (300_001, 3, 1024, 7),         # n % 4 != 0: the scalar path
    (1_000_000, 2, 4096, 32),      # 8 lane groups of 4
    (1_000_000, 2, 65_536, 32),    # 4 bin windows a feature, a lane a group
    (200_000, 1, 65_536, 200),     # more lane groups than SMs: 2 launches
])
def test_wide_histogram_kernel_matches_plain(cuda_device, int_mode, n, F, B,
                                             K):
    """Kernel A on uint16 bins (ids of 32,768 and above at B = 65,536),
    with -1 rows and -1 lanes: int mode bit-equal to the plain version;
    f32 mode within the order tolerance, and bit-equal on exact-sum
    values."""
    rng = np.random.default_rng(B + F)
    bins = torch.from_numpy(rng.integers(0, B, size=(F, n)).astype(
        np.uint16)).to(cuda_device)
    vals = (torch.from_numpy(rng.integers(-3, 4, size=(3, n)).astype(
        np.float32)) if int_mode else torch.randn(3, n)).to(cuda_device)
    leaf = torch.from_numpy(rng.integers(-1, 40, size=n).astype(
        np.int32)).to(cuda_device)
    ids = torch.arange(K, dtype=torch.int32, device=cuda_device)
    ids[::5] = -1
    before = (th.multi_leaf_histogram.launches,
              th.multi_leaf_histogram.launches_u16)
    out = th.multi_leaf_histogram(bins, vals, leaf, ids, num_bins=B,
                                  int_mode=int_mode)
    assert (th.multi_leaf_histogram.launches,
            th.multi_leaf_histogram.launches_u16) == (before[0] + 1,
                                                      before[1] + 1)
    plain = th.multi_leaf_histogram_plain(bins, vals, leaf, ids, num_bins=B,
                                          int_mode=int_mode)
    if int_mode:
        assert torch.equal(out, plain)
        return
    tol = 2.0 ** -20 * vals.to(torch.bfloat16).float().abs().sum(1)
    assert bool(((out - plain).abs() <= tol).all())
    ev = _exact_f32_vals(rng, 3, n).to(cuda_device)
    assert torch.equal(
        th.multi_leaf_histogram(bins, ev, leaf, ids, num_bins=B),
        th.multi_leaf_histogram_plain(bins, ev, leaf, ids, num_bins=B))


@pytest.mark.parametrize("n,F", [(1_000_448, 28), (123_457, 3), (4097, 1)])
def test_wide_moves_match_plain(cuda_device, n, F):
    """B and B′ on 2-byte bin rows (ids of 32,768 and above), bit-equal to
    their plain versions; odd widths take the rows one at a time."""
    rng = np.random.default_rng(n)
    bins = torch.from_numpy(rng.integers(0, 65_536, size=(F, n)).astype(
        np.uint16)).to(cuda_device)
    vals = torch.randn(4, n, device=cuda_device)
    keep = torch.rand(n, device=cuda_device) < 0.3
    out_cols = int(keep.sum()) + 777
    c0 = tc.compact_by_mask.launches_u16
    got = tc.compact_by_mask(bins, vals, keep, out_cols)
    want = tc.compact_by_mask_plain(bins, vals, keep, out_cols)
    assert tc.compact_by_mask.launches_u16 == c0 + 1
    assert got[0].dtype == torch.uint16
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    old = torch.randint(0, 30, (n,), dtype=torch.int32, device=cuda_device)
    new = torch.where(torch.rand(n, device=cuda_device) < 0.4, old + 30, old)
    v3 = vals[:3].contiguous()
    p0 = tp.partition_move.launches_u16
    (kb, kv, kl), knf, kcum = tp.partition_move(bins, v3, old, new)
    (pb, pv, pl), pnf, pcum = tp.partition_move_plain(bins, v3, old, new)
    assert tp.partition_move.launches_u16 == p0 + 1
    assert torch.equal(kb.view(torch.int16), pb.view(torch.int16))
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    assert torch.equal(kl, pl) and torch.equal(kcum, pcum)
    assert int(knf) == int(pnf)


# case -> (rows, params) at max_bin 1023; GOSS from iteration 1/lr = 3
WIDE_CASES = {
    "masked": (5000, {"bagging_fraction": 0.7, "bagging_freq": 1}),
    "exact": (5000, {"use_quantized_grad": False}),
    "goss": (16_000, {"data_sample_strategy": "goss", "top_rate": 0.1,
                      "other_rate": 0.05, "tpu_goss_compact": True}),
    "partition": (5000, {"tpu_hist_partition": "true"}),
    "categorical": (5000, {}),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_training_card_matches_cpu(cuda_device, case):
    """max_bin 1023 (uint16 bins) trained on the card and on the CPU from
    the same data and draws: identical split lines, predictions within
    1e-5; the card's runs launch the uint16 kernels."""
    import lightgbm_tpu_torch as lgt
    n, extra = WIDE_CASES[case]
    rng = np.random.default_rng(3)
    X = np.round(rng.normal(size=(n + 1000, 8)), 2)
    cat = []
    if case == "categorical":
        X[:, 7] = rng.integers(0, 1000, size=len(X))
        cat = [7]
    y = (X[:, 0] + X[:, 1] * X[:, 2] + (X[:, 7] % 5 == 1)
         + rng.normal(size=len(X)) > 0).astype(np.float64)
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child", "num_leaves", "cat_threshold")
    out = {}
    u16 = (th.multi_leaf_histogram.launches_u16,
           tc.compact_by_mask.launches_u16, tp.partition_move.launches_u16)
    for dev in ("cuda", "cpu"):
        bst = lgt.train(dict({"objective": "binary", "num_leaves": 15,
                              "max_bin": 1023, "tpu_leaf_batch": 4,
                              "learning_rate": 0.3,
                              "use_quantized_grad": True,
                              "stochastic_rounding": False, "verbosity": -1,
                              "device_type": dev}, **extra),
                        lgt.Dataset(X[:n], label=y[:n],
                                    categorical_feature=cat),
                        num_boost_round=5, noise=_SameDraws(dev))
        assert bst.engine.data.bins.dtype == torch.uint16
        assert bst.engine.use_goss_compact == (case == "goss")
        out[dev] = ([ln for ln in bst.model_to_string().splitlines()
                     if ln.split("=", 1)[0] in keys], bst.predict(X[n:]))
    assert th.multi_leaf_histogram.launches_u16 > u16[0]
    assert (tc.compact_by_mask.launches_u16 > u16[1]) == (case == "goss")
    assert (tp.partition_move.launches_u16 > u16[2]) == (case == "partition")
    assert out["cuda"][0] == out["cpu"][0]
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-5)
