"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``lightgbm_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and then runs these phases:

1. kernel A (multi-leaf histogram) and kernel B (``compact_by_mask``, the
   GOSS compaction) against their plain torch versions at the training
   paths' shapes (kernel A also at the 2M-row run's padded rows, on one
   span round of its partition and with skewed bins), timed; kernel B
   over 20 launches bit-equal to the plain version;
2. kernel B′ (``partition_move``) at the 2M-row run's padded width (moved
   fractions 0.5 and 0.001), 20 launches bit-equal to its plain version
   (columns, prefix sums and front size), timed; B and B′ are timed in
   turns with the parent's whole main-path step (plan, zero-fills and
   dest-driven kernel), built from ``build/move_parent/`` when present;
3. the two histogram probe kernels at their probe shapes (the 1-D probe
   at the TPU probe's shape, every row in lane 0, and with ids uniform
   over 32 lanes; the nibble probe at nb = 16, 32, 64) within the f32
   tolerance of the plain version and bit-equal to it on exact-sum
   inputs, timed beside kernel A in f32 mode; the 1-D probe's passes
   and the nibble probe's cluster plan are printed; sources under
   ``build/hist_extra/`` are timed beside them in turns: a nibble-probe
   source (an earlier ``hist_probes.cu``) beside the nibble probe, and a
   ``probe1d_*.cu`` (the parent's ``hist_probes.cu``, the other design
   of the adds, stripped copies) beside the 1-D probe, with the split of
   its time that the stripped copies give;
4. the Higgs flagship (1M rows x 28 features, binary, 127 leaves, 255
   bins, GOSS with the compacted histogram buffer, quantized gradients)
   for 16 rounds through ``Booster.update``: holdout AUC and a model-text
   round trip;
5. full-row training (2M rows, no GOSS, bagging 0.8, feature_fraction
   0.8, quantized gradients) for 16 rounds, once with
   ``tpu_hist_partition=false`` and once with ``true``: ``true`` must
   engage the row partition and launch the move kernel every iteration,
   the two model texts must be byte-equal and the partition must scan
   fewer rows; then two more iterations of each (and of the flagship's
   GOSS) under torch.profiler give the device's idle share, the move and
   compaction kernels' device ms and the device-to-host copies per
   iteration (at most 28 with the partition off, 36 on);
6. the replay: the histogram calls of one tree of each training run,
   recorded on the way (the flagship's last full-row and last GOSS tree,
   one more tree of each full-row run, with the partition the first that
   has a span round), each held bit for bit against the plain version
   (int mode, and f32 mode on exact-sum values) and timed beside the
   plain version, an int and an f32 ``index_add_`` and the bound; a
   histogram source under ``build/hist_extra/`` (an earlier
   ``histogram.cu``) is built and timed beside kernel A in turns;
7. the partition sweep: full-row training with the partition off and
   forced on in turns (off, on, on, off), 8 rounds a run, at 2M, 8M and
   10M rows: it/s, rows scanned, model text byte-equal (what decides the
   ``tpu_hist_partition=auto`` policy);
8. the objectives, on the full-row settings: L2 regression on 2M
   Higgs-shaped rows (label: the logit plus noise), 10 rounds, partition
   off and forced on (kernel A in int mode, B′ every iteration with the
   partition, model text byte-equal, holdout l2 against the label's
   variance); multiclass softmax with 7 classes at the UCI Covertype shape
   (581,012 x 54), 10 rounds, so 70 trees (int mode, 9 kernel-A calls a
   class tree; holdout multi_logloss and multi_error); quantile (alpha
   0.9) on 1M rows, 5 rounds (f32 mode; the host leaf renewal timed);
   then every ported objective for 5 rounds on 20k rows, 31 leaves,
   quantized gradients without stochastic rounding, once on the card and
   once on the CPU: split lines identical, predictions within 1e-5;
9. categorical features: ``bench.py``'s categorical guard at its own size
   and settings (``synth_guard``, 200k training rows, 50k holdout, 63
   leaves, 50 rounds) with its two categorical columns (holdout AUC above
   bench.py's floor 0.85) and with them numeric; the Criteo shape of
   ``benchmarks/suite.py`` (1M x 199, 26 categorical columns, 127 leaves,
   no EFB) on the masked path, GOSS with compaction and the forced
   partition, 10 rounds each (GOSS 10 more first, as it starts at
   iteration 1 / learning rate), each traced, the partition's model text
   byte-equal to the masked run's, and one more iteration's kernel-A
   calls, GOSS compaction and partition moves at F = 199 held against
   their plain versions; then a 20k-row guard-shaped set (with a 3-way
   column and NaN in the categorical columns) on the three paths, binary
   on quantized and exact gradients and 3-class multiclass, on the card
   and on the CPU;
10. learning to rank: the MSLR-Web30K shape of ``benchmarks/suite.py``'s
   ``bench_mslr`` (4,096 training queries of 122 documents, 136
   features, relevance 0-4, lambdarank, 127 leaves, 1,024 queries held
   out) on the masked path with exact gradients (kernel A in f32 mode)
   and quantized (int mode), GOSS with compaction (B at 136 bin rows)
   and the forced partition (B′), 10 rounds each (GOSS 10 more first),
   then rank_xendcg and ``lambdarank_unbiased`` for 5; each traced, with
   holdout ndcg@1, 3, 5 and 10 and the gradient's device ms; the
   partition's text byte-equal to the quantized masked run's; one more
   quantized iteration's kernel-A calls, a compaction and the partition
   moves at F = 136 held against their plain versions; MSLR-Web30K
   Fold 1's query-length spread (18,919 queries, 2.27M rows, the longest
   1,251 documents) for 5 rounds: host binning time, it/s, the
   gradient's device ms and peak memory, and the share of the padded
   pair work on real documents; then lambdarank (quantized and exact),
   rank_xendcg and position-debiased lambdarank on a 20k-row ranking set
   on the three paths, on the card and on the CPU.

Each training run sets the kernels' launch counts to 0 just before it
and reads them just after. The last two lines of standard output are the
per-kernel JSON line and the result line ``{"ok": true, "device":
{...}}``; any failure exits non-zero before the result line.
``--json-out PATH`` also writes the per-kernel record, replay included,
to PATH; ``--only-probes``, ``--only-sweep``, ``--only-objectives``,
``--only-categorical`` and ``--only-ranking`` build the kernels, run phase
3, 7, 8, 9 or 10 and stop (no result line). It needs a CUDA device and
imports neither JAX nor ``lightgbm_tpu``.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peak rates (NVIDIA data sheet, full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12            # CUDA-core float32 / int32 adds

N_TRAIN, N_HOLDOUT, N_FEAT = 1_000_000, 100_000, 28
ROUNDS = 16
TRACE_ROUNDS = 2                 # profiled iterations after the full-row runs
SPAN_SEARCH = 12                 # more iterations to find a tree with span rounds
PARAMS = {"objective": "binary", "num_leaves": 127, "max_bin": 255,
          "learning_rate": 0.1, "use_quantized_grad": True,
          "stochastic_rounding": True, "data_sample_strategy": "goss",
          "tpu_leaf_batch": 32, "tpu_hist_mode": "pool",
          "tpu_goss_compact": True, "metric": "auc", "verbosity": -1,
          "device_type": "cuda"}
# main-path histogram shapes: padded rows of the masked iterations and the
# GOSS buffer (lightgbm_tpu_torch.boosting.gbdt: n_pad and goss_n_sub)
HIST_F, HIST_B, HIST_K, HIST_C = 28, 256, 32, 3
INACTIVE_LANES = (5, 17, 30)     # lanes with small id -1 in a round
# histogram sources timed beside kernel A on the recorded calls when
# present (git-ignored; relative to this script's directory)
HIST_EXTRA_DIR = os.path.join("build", "hist_extra")
# the parent's dest-driven partition.cu and compact.cu, timed in turns
# beside kernels B′ and B when present (git-ignored)
MOVE_PARENT_DIR = os.path.join("build", "move_parent")
REPEATS = 20                     # launches of B′ and B held to the plain one
# kernel names whose device time trace_rounds reports per iteration
STEP_KERNELS = ("partition_kernel", "compact_kernel")
# the reads the training runs may make per iteration (the host's blocking
# device-to-host copies): partition off, on
MAX_DTOH = {"false": 28, "true": 36}
# partition off / forced on in turns at these rows (10M: bench.py's
# default size), SWEEP_ROUNDS rounds a run
SWEEP_ROWS = (2_000_000, 8_000_000, 10_000_000)
SWEEP_ROUNDS = 8
# the replay numbers the per-kernel JSON line carries (--json-out PATH
# writes them all)
REPLAY_KEYS = ("tree", "kind", "n", "live_lanes", "matched_rows",
               "int_kernel_ms", "f32_kernel_ms", "bound_ms",
               "library_int_ms", "library_f32_ms")
# the span budget of the full-row run's span rounds: the largest S with
# 32 x S < the padded 2M rows (lightgbm_tpu_torch.ops.partition.span_budgets)
SPAN_BUDGET = 32_768
# full-row training: the flagship without GOSS, with bagging and
# feature_fraction, 2M rows, the leaf-ordered row partition off and forced
# on (tpu_hist_partition=auto stands down on the card)
N_FULL = 2_000_000
FULL_PARAMS = {"objective": "binary", "num_leaves": 127, "max_bin": 255,
               "learning_rate": 0.1, "stochastic_rounding": True,
               "bagging_fraction": 0.8, "bagging_freq": 1,
               "feature_fraction": 0.8, "tpu_leaf_batch": 32,
               "tpu_hist_mode": "pool", "metric": "auc", "verbosity": -1,
               "device_type": "cuda"}
# the objectives phase: regression (L2) at 2M Higgs-shaped rows, partition
# off and forced on; multiclass at the UCI Covertype shape; quantile with
# its host leaf renewal; then every ported objective on the card and on
# the CPU. Each on FULL_PARAMS' full-row settings.
N_REG, REG_ROUNDS = 2_000_000, 10
N_COVTYPE, N_COVTYPE_HOLDOUT, MC_ROUNDS = 581_012, 58_101, 10
COVTYPE_SHARES = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353)
N_QUANTILE, QUANTILE_ROUNDS = 1_000_000, 5
N_PARITY, N_PARITY_HOLDOUT, PARITY_ROUNDS = 20_000, 2_000, 5
PARITY_PARAMS = {"num_leaves": 31, "max_bin": 255, "learning_rate": 0.1,
                 "use_quantized_grad": True, "stochastic_rounding": False,
                 "tpu_leaf_batch": 8, "verbosity": -1}
PARITY_OBJECTIVES = {
    "regression": {"objective": "regression"},
    "regression_sqrt": {"objective": "regression", "reg_sqrt": True},
    "regression_l1": {"objective": "regression_l1"},
    "huber": {"objective": "huber", "alpha": 1.5},
    "fair": {"objective": "fair", "fair_c": 2.0},
    "poisson": {"objective": "poisson"},
    "quantile": {"objective": "quantile", "alpha": 0.8},
    "mape": {"objective": "mape"},
    "gamma": {"objective": "gamma"},
    "tweedie": {"objective": "tweedie", "tweedie_variance_power": 1.4},
    "binary": {"objective": "binary"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "multiclassova": {"objective": "multiclassova", "num_class": 3},
    "cross_entropy": {"objective": "cross_entropy"},
    "cross_entropy_lambda": {"objective": "cross_entropy_lambda"},
}
PARITY_PRED_TOL = 1e-5          # |card - CPU| <= tol * max(1, |CPU|)
SPLIT_KEYS = ("split_feature", "threshold", "decision_type", "left_child",
              "right_child", "num_leaves")
# the categorical phase: bench.py's categorical guard (bench.py:402-412)
N_GUARD, N_GUARD_TRAIN, GUARD_ROUNDS = 250_000, 200_000, 50
GUARD_CATS = [10, 11]
GUARD_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 255,
                "learning_rate": 0.1, "metric": "auc", "verbosity": -1,
                "device_type": "cuda"}
# the Criteo shape (benchmarks/suite.py::bench_criteo) without EFB, which
# the port does not have; AUC on the first 100k rows, as the suite's
N_CRITEO, CRITEO_ROUNDS, CRITEO_AUC_ROWS = 1_000_000, 10, 100_000
CRITEO_CATS = list(range(13, 39))
CRITEO_PARAMS = {"objective": "binary", "num_leaves": 127, "max_bin": 255,
                 "learning_rate": 0.1, "enable_bundle": False,
                 "verbosity": -1, "device_type": "cuda"}
CRITEO_PATHS = {
    "masked": {"tpu_hist_partition": "false"},
    "goss": {"data_sample_strategy": "goss", "tpu_goss_compact": True,
             "stochastic_rounding": True, "tpu_hist_partition": "false"},
    "partition": {"tpu_hist_partition": "true"},
}
# categorical card against CPU (on PARITY_PARAMS, N_PARITY rows)
CAT_PARITY_SETTINGS = {
    "binary_quantized": {"objective": "binary"},
    "binary_exact": {"objective": "binary", "use_quantized_grad": False},
    "multiclass": {"objective": "multiclass", "num_class": 3},
}
CAT_PARITY_PATHS = {
    "masked": {},
    # GOSS from iteration 1 / 0.3 = 3 of the 5
    "goss": {"data_sample_strategy": "goss", "learning_rate": 0.3},
    "partition": {"tpu_hist_partition": "true"},
}
# the probes' shapes (benchmarks/kernel_probe.py:7-12, every row in lane
# 0, and benchmarks/nibble_probe.py:25-31, ids uniform over the lanes),
# the 1-D probe also at the nibble probe's: probe, F, n, B, K, C, leaf ids
PROBE_SHAPES = {
    "hist_probe_1d": ("hist_probe_1d", 28, 1_048_576, 256, 16, 3, "lane0"),
    "hist_probe_1d_uniform": ("hist_probe_1d", 28, 1_048_576, 256, 32, 3,
                              "uniform"),
    "hist_probe_nibble": ("hist_probe_nibble", 28, 1_048_576, 256, 32, 3,
                          "uniform")}
# 1-D probe sources under HIST_EXTRA_DIR: files named PROBE_1D_EXTRA*.cu
PROBE_1D_EXTRA = "probe1d_"
# the stripped copies of the 1-D probe whose times split the kernel's:
# without the adds, without the reduction, without both
# (chip_variants.py --probe-extras writes them)
PROBE_1D_SPLIT = ("probe1d_no_adds", "probe1d_no_reduce",
                  "probe1d_no_adds_no_reduce")
# the ranking phase: the MSLR-Web30K shape of benchmarks/suite.py::bench_mslr
# (:31-56) at its own size and settings: 4,096 training queries of 122
# documents, 136 features, relevance 0-4, lambdarank, 127 leaves; 1,024
# more queries of the same generator held out whole
N_MSLR_QUERIES, N_MSLR_TRAIN_QUERIES, MSLR_DOCS, MSLR_F = 5120, 4096, 122, 136
MSLR_ROUNDS, MSLR_SIDE_ROUNDS = 10, 5
MSLR_PARAMS = {"objective": "lambdarank", "num_leaves": 127, "max_bin": 255,
               "learning_rate": 0.1, "eval_at": [1, 3, 5, 10],
               "verbosity": -1, "device_type": "cuda"}
MSLR_PATHS = {
    "masked": {"tpu_hist_partition": "false"},
    "quantized": {"use_quantized_grad": True, "tpu_hist_partition": "false"},
    "goss": {"use_quantized_grad": True, "data_sample_strategy": "goss",
             "tpu_goss_compact": True, "tpu_hist_partition": "false"},
    "partition": {"use_quantized_grad": True, "tpu_hist_partition": "true"},
}
# the other objectives on the masked path, MSLR_SIDE_ROUNDS rounds each
MSLR_SIDE = {"rank_xendcg": {"objective": "rank_xendcg"},
             "lambdarank_unbiased": {"lambdarank_unbiased": True}}
# MSLR-Web30K Fold 1's training set: 18,919 queries of about 120 documents
# on average (2.27M rows), the longest 1,251
N_LENGTHS_QUERIES, LENGTHS_MAX, LENGTHS_ROUNDS = 18_919, 1_251, 5
# ranking card against CPU: a 20k-row MSLR-shaped set on PARITY_PARAMS
# with 16 gradient bins (with 4 and no stochastic rounding nearly every
# lambdarank gradient rounds to level 0)
N_RANK_PARITY = 20_000
RANK_PARITY_PARAMS = dict(PARITY_PARAMS, num_grad_quant_bins=16,
                          eval_at=[5])
RANK_PARITY_SETTINGS = {
    "lambdarank_quantized": {"objective": "lambdarank"},
    "lambdarank_exact": {"objective": "lambdarank",
                         "use_quantized_grad": False},
    "rank_xendcg": {"objective": "rank_xendcg"},
    "lambdarank_position": {"objective": "lambdarank"},
}


def synth_higgs(n, f, seed=0, regression=False):
    """Higgs-like data: the port's copy of bench.py::synth_higgs; with
    ``regression`` the label is the logit plus the noise, unthresholded."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f)
    logit = (X @ w * 0.5 + 0.8 * X[:, 0] * X[:, 1]
             + 0.5 * np.abs(X[:, 2]) - 0.4)
    y = logit + rng.normal(scale=1.0, size=n)
    if not regression:
        y = (y > 0).astype(np.float64)
    return X.astype(np.float64), y


def synth_covtype(n, seed=0):
    """Covertype-shaped data (UCI Covertype: 54 features = 10 continuous,
    4 one-hot wilderness areas, 40 one-hot soil types; 7 cover types at
    the data set's class shares), synthesized: the label is the argmax of
    per-class linear scores of the continuous features, per-class effects
    of the area and soil, the log class shares and Gumbel noise."""
    rng = np.random.default_rng(seed)
    K = len(COVTYPE_SHARES)
    cont = rng.normal(size=(n, 10)).astype(np.float32)
    wild = rng.integers(0, 4, size=n)
    soil = rng.integers(0, 40, size=n)
    X = np.zeros((n, 54), np.float32)
    X[:, :10] = cont
    X[np.arange(n), 10 + wild] = 1.0
    X[np.arange(n), 14 + soil] = 1.0
    score = (cont @ rng.normal(size=(10, K)) + rng.normal(size=(4, K))[wild]
             + rng.normal(size=(40, K))[soil] + np.log(COVTYPE_SHARES)
             + rng.gumbel(size=(n, K)))
    return X.astype(np.float64), np.argmax(score, axis=1).astype(np.float64)


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms (CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms, host overhead excluded: a spin
    kernel (``torch.cuda._sleep``) holds the device while the host queues
    ``reps`` calls, so the CUDA events around them time only the device's
    work and the gaps between its launches. The spin is doubled until it
    outlasts the queueing (a few times at most: ``fn`` must not wait for
    the device, as a boolean mask select does; time such calls with
    ``time_ms``)."""
    for _ in range(warmup):
        fn()
    cycles = 1 << 24
    for _ in range(4):
        torch.cuda.synchronize()
        s0, start = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        end = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(cycles)
        start.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        queued_ms = (time.perf_counter() - t) * 1e3
        end.record()
        torch.cuda.synchronize()
        if s0.elapsed_time(start) > 1.2 * queued_ms:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError(f"device_ms: {reps} calls took {queued_ms:.2f} ms "
                       "to queue, longer than the spin: the call waits "
                       "for the device")


def bound(nbytes, nops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_tolerance(vals):
    """Per-channel bound of an f32-mode histogram's summation order:
    2^-20 x the channel's sum of |bf16 values|."""
    return 2.0 ** -20 * vals.to(torch.bfloat16).float().abs().sum(1)


def exact_f32_vals(rng, C, n):
    """f32 values whose bf16 roundings are k/128 (|k| in 1..256), each off
    its rounding by up to 2^-10 relative. Cells of up to 2^16 rows then
    sum exactly in float32 in any order (every partial sum is a multiple
    of 2^-7 below 2^17), so an f32-mode histogram that keeps the bf16
    operands equals its plain version bit for bit, and one that sums the
    unrounded values does not."""
    k = rng.integers(1, 257, size=(C, n)) * rng.choice([-1, 1], size=(C, n))
    r = rng.uniform(-2.0 ** -10, 2.0 ** -10, size=(C, n))
    return torch.from_numpy((k / 128 * (1 + r)).astype(np.float32))


def check_f32(name, got, ref, vals, exact):
    """Hold an f32-mode histogram against the plain one: bit for bit on
    ``exact_f32_vals`` inputs, else within ``f32_tolerance``. Returns the
    max |diff|."""
    err = float((got - ref).abs().max())
    ok = (torch.equal(got, ref) if exact else bool(
        ((got - ref).abs() <= f32_tolerance(vals)[None, None, None, :])
        .all()))
    if not ok:
        raise AssertionError(f"{name}: max |diff| {err} "
                             + ("on exact-sum inputs" if exact
                                else "over the f32 tolerance"))
    return err


def lane_index(bins, vals, leaf, ids, B):
    """One ``index_add_``'s flat [K*F*B*C] index and source for a
    multi-leaf histogram (every row-lane match, as the contract counts a
    repeated id; a negative id matches nothing), and the rows that match
    a lane: (idx, src, matched rows, row-lane pairs)."""
    F, C, K = bins.shape[0], vals.shape[0], ids.shape[0]
    dev = bins.device
    f_idx = torch.arange(F, device=dev)[:, None]
    c_idx = torch.arange(C, device=dev)
    idx, src = [], []
    for k in range(K):
        if int(ids[k]) < 0:
            continue
        rows = torch.nonzero(leaf == ids[k]).flatten()
        cell = (k * F + f_idx) * B + bins[:, rows].long()          # [F, m]
        idx.append((cell[:, :, None] * C + c_idx).reshape(-1))
        src.append(vals[:, rows].T[None].expand(F, -1, C).reshape(-1))
    live = ids[ids >= 0]
    any_lane = (leaf[None, :] == live[:, None]).any(0)
    pairs = sum(int(i.numel()) for i in idx) // (F * C)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    return (torch.cat(idx) if idx else empty,
            torch.cat(src) if src else empty.to(vals.dtype),
            int(any_lane.sum()), pairs)


def span_case(rng, bins_p, leaf_p, tp):
    """The histogram input of one span round, as the partitioned grow loop
    builds it: n rows grouped by leaf (127 leaves in shuffled order), K
    lanes of which 3 are inactive (-1, count 0) and the rest elected
    children of 1..S rows (one at offset 0, one at the end, where the
    window's start clamps), cut by ``slice_spans`` to S = 32,768 columns
    each; rows of neighbouring leaves inside a window carry leaf id -1.
    Returns (bins, leaf ids, small ids, values -> span values)."""
    n, L, S = leaf_p.shape[0], 127, SPAN_BUDGET
    ids = rng.permutation(L)[:HIST_K].astype(np.int32)
    ids[list(INACTIVE_LANES)] = -1
    act = ids[ids >= 0]
    cnt = np.zeros(L + 1, np.int64)                 # slot L: the trash
    cnt[act] = rng.integers(1, S + 1, size=act.size)
    rest = np.setdiff1d(np.arange(L), act)
    cnt[rest] = rng.multinomial(n - cnt[act].sum(), np.ones(rest.size)
                                / rest.size)
    order = np.concatenate([act[:1], rng.permutation(
        np.concatenate([act[2:], rest])), act[1:2]])
    off = np.zeros(L + 1, np.int64)
    off[order] = np.cumsum(cnt[order]) - cnt[order]
    leaf_p.copy_(torch.from_numpy(np.repeat(order, cnt[order])
                                  .astype(np.int32)))
    dev = leaf_p.device
    ids = torch.from_numpy(ids).to(dev)
    safe = ids.clamp(0, L).long()
    offs = torch.from_numpy(off.astype(np.int32)).to(dev)[safe]
    cnts = torch.where(ids >= 0, torch.from_numpy(cnt.astype(np.int32))
                       .to(dev)[safe], 0)
    bins, _, leaf = tp.slice_spans(bins_p, bins_p[:1].float(), leaf_p, offs,
                                   cnts, S)
    return bins, leaf, ids, lambda v: tp.slice_spans(
        bins_p, v, leaf_p, offs, cnts, S)[1].contiguous()


def histogram_phase(dev, th, tp, n_full_pad):
    """Kernel A at the main paths' shapes, int and f32 mode: the GOSS
    flagship's padded rows and GOSS buffer, the full-row run's padded
    rows (the masked scan, and the partition's fallback scan), one span
    round of the partitioned run (``span_case``), and the flagship's
    padded rows with skewed bins (90% of each feature's rows in one
    bin)."""
    rng = np.random.default_rng(1)
    out = {}
    for label, n in (("masked", 1_003_520), ("goss", 311_296),
                     ("full_row", n_full_pad), ("spans", n_full_pad),
                     ("skewed", 1_003_520)):
        bins = rng.integers(0, HIST_B, size=(HIST_F, n)).astype(np.uint8)
        if label == "skewed":            # 90% of each feature's rows in one bin
            bins[rng.random((HIST_F, n)) < 0.9] = 17
        bins = torch.from_numpy(bins).to(dev)
        levels = np.stack([rng.integers(-2, 3, size=n),
                           rng.integers(0, 4, size=n),
                           (rng.random(n) < 0.9)]).astype(np.float32)
        vals = {"int": torch.from_numpy(levels),
                "f32": torch.from_numpy(rng.normal(size=(HIST_C, n))
                                        .astype(np.float32)),
                "exact": exact_f32_vals(rng, HIST_C, n)}
        vals = {m: v.to(dev) for m, v in vals.items()}
        if label == "spans":
            leaf_p = torch.empty(n, dtype=torch.int32, device=dev)
            bins, leaf, ids, take = span_case(rng, bins, leaf_p, tp)
            vals = {m: take(v) for m, v in vals.items()}
            n = leaf.shape[0]
        else:
            leaf = torch.from_numpy(rng.integers(0, 2 * HIST_K, size=n)
                                    .astype(np.int32)).to(dev)
            ids = np.arange(HIST_K, dtype=np.int32) * 2
            ids[list(INACTIVE_LANES)] = -1
            ids = torch.from_numpy(ids).to(dev)
        res = {}
        for mode, v in vals.items():
            args = (bins, v, leaf, ids)
            kw = dict(num_bins=HIST_B, int_mode=mode == "int")
            got = th.multi_leaf_histogram(*args, **kw)
            ref = th.multi_leaf_histogram_plain(*args, **kw)
            torch.cuda.synchronize()
            if mode == "int":
                err = float((got - ref).abs().max())
                if not torch.equal(got, ref):
                    raise AssertionError(f"histogram int mode {label}: "
                                         f"max |diff| {err}")
            else:
                err = check_f32(f"histogram {mode} mode {label}", got, ref,
                                v, exact=mode == "exact")
            res[mode] = dict(max_abs_err=err)
            if mode == "exact":
                continue
            res[mode].update(
                ms=time_ms(lambda: th.multi_leaf_histogram(*args, **kw)),
                plain_ms=time_ms(lambda: th.multi_leaf_histogram_plain(
                    *args, **kw), reps=3, warmup=1))
        # library yardstick: one index_add_ into the flat [K*F*B*C]
        # buffer, its index computed before the timed call; int levels,
        # and the f32 values rounded to bf16
        idx, src, m, pairs = lane_index(bins, vals["int"].to(torch.int32),
                                        leaf, ids, HIST_B)
        buf = torch.zeros(HIST_K * HIST_F * HIST_B * HIST_C,
                          dtype=torch.int32, device=dev)
        lib_ms = time_ms(lambda: buf.index_add_(0, idx, src), reps=5)
        idx, src, _, _ = lane_index(bins, vals["f32"].to(torch.bfloat16)
                                    .float(), leaf, ids, HIST_B)
        fbuf = buf.view(torch.float32)
        lib_f32_ms = time_ms(lambda: fbuf.index_add_(0, idx, src), reps=5)
        del idx, src
        # the work this data needs: every leaf id, the bins and values of
        # the m rows that match a lane, the output once; an add per
        # row-lane match, feature and channel
        nbytes = (4 * n + (HIST_F + 4 * HIST_C) * m + 4 * HIST_K
                  + 4 * HIST_K * HIST_F * HIST_B * HIST_C)
        b_ms, b_by = bound(nbytes, pairs * HIST_F * HIST_C)
        out[label] = dict(n=n, matched_rows=m, row_lane_matches=pairs,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          library_f32_ms=lib_f32_ms,
                          **{f"{mode}_{k}": v for mode, r in res.items()
                             for k, v in r.items()})
        print(f"histogram {label} n={n} (rows matching a lane {m}, "
              f"row-lane matches {pairs}): int kernel "
              f"{res['int']['ms']:.4f} ms (plain {res['int']['plain_ms']:.2f}"
              f" ms, index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms); "
              f"f32 kernel {res['f32']['ms']:.4f} ms (index_add_ "
              f"{lib_f32_ms:.4f} ms), max |diff| "
              f"{res['f32']['max_abs_err']:.3g}; exact-sum f32 bit-equal",
              flush=True)
    return out


class HistRecorder:
    """Records the multi-leaf histogram calls of chosen trees. It takes the
    place of the name the grow loop calls
    (``learner.serial.multi_leaf_histogram``) and passes every call on to
    what stood there before (the wrapper, or another counter in front of
    it), so launch counts are unchanged; while ``tag`` is set it also
    keeps a copy of the call's inputs."""

    def __init__(self, serial, th):
        self.serial, self.th = serial, th
        self.prev = serial.multi_leaf_histogram
        self.tag = None
        self.calls = []
        self.impl = None                 # another histogram, for an A/B
        serial.multi_leaf_histogram = self

    def __call__(self, bins_t, vals_t, leaf_id, small_ids, **kw):
        if self.tag is not None:
            self.calls.append(dict(tree=self.tag, kw=kw, args=tuple(
                t.clone() for t in (bins_t, vals_t, leaf_id, small_ids))))
        if self.impl is not None:
            return self.impl(bins_t, vals_t, leaf_id, small_ids, **kw)
        return self.prev(bins_t, vals_t, leaf_id, small_ids, **kw)

    def close(self):
        self.serial.multi_leaf_histogram = self.prev


def start_extra_builds(kernels):
    """Start one ``nvcc`` for each source under ``build/hist_extra/``: an
    earlier ``histogram.cu`` or a variant of it (C entry
    ``lgbt_multi_leaf_histogram``, a zeroed output), an earlier
    ``hist_probes.cu`` or a variant of it (C entry
    ``lgbt_hist_probe_nibble``, a zeroed output), or, named
    ``probe1d_*.cu``, a ``hist_probes.cu`` whose ``lgbt_hist_probe_1d``
    is timed beside the 1-D probe. The directory is git-ignored and
    usually absent. Returns {name: (process, .so)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    src_dir = os.path.join(root, HIST_EXTRA_DIR)
    if not os.path.isdir(src_dir):
        return {}
    jobs = {}
    for fn in sorted(os.listdir(src_dir)):
        if not fn.endswith(".cu"):
            continue
        name = fn[:-3]
        so = os.path.join(src_dir, f"lib{name}.so")
        jobs[name] = (subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so,
             os.path.join(src_dir, fn)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    return jobs


def finish_extra_builds(jobs):
    """Wait for ``start_extra_builds``; returns ({name: histogram C
    entry}, {name: nibble-probe C entry}, {name: 1-D probe call}, {name:
    .so path})."""
    import ctypes
    hists, nibbles, probes, paths = {}, {}, {}, {}
    for name, (proc, so) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {HIST_EXTRA_DIR}/{name}.cu"
                               f":\n{text}")
        lib = ctypes.CDLL(so)
        paths[name] = so
        if name.startswith(PROBE_1D_EXTRA):
            probes[name] = extra_probe_1d(lib)
            continue
        nibble = hasattr(lib, "lgbt_hist_probe_nibble")
        fn = (lib.lgbt_hist_probe_nibble if nibble
              else lib.lgbt_multi_leaf_histogram)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        (nibbles if nibble else hists)[name] = fn
    return hists, nibbles, probes, paths


def extra_histogram(fn, bins, vals, leaf, ids, num_bins, int_mode):
    """One call of an extra histogram library, wrapped as the earlier
    wrapper did: a zeroed int32 (int mode) or f32 output, the kernel, and
    the cast to f32."""
    F, n = bins.shape
    C, K = vals.shape[0], ids.shape[0]
    out = torch.zeros((K, F, num_bins, C), device=bins.device,
                      dtype=torch.int32 if int_mode else torch.float32)
    rc = fn(bins.data_ptr(), vals.data_ptr(), leaf.data_ptr(),
            ids.data_ptr(), n, F, C, K, num_bins, int(int_mode),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extra histogram kernel: CUDA error {rc}")
    return out.to(torch.float32) if int_mode else out


def extra_nibble(fn, bins, vals, leaf, ids, num_bins, nb):
    """One call of an extra nibble-probe library, wrapped as the earlier
    wrapper did: a zeroed f32 output, then the kernel."""
    F, n = bins.shape
    C, K = vals.shape[0], ids.shape[0]
    out = torch.zeros((K, F, num_bins, C), device=bins.device,
                      dtype=torch.float32)
    rc = fn(bins.data_ptr(), vals.data_ptr(), leaf.data_ptr(),
            ids.data_ptr(), n, F, C, K, num_bins, nb, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"extra nibble probe kernel: CUDA error {rc}")
    return out


def extra_probe_1d(lib):
    """A call of an extra 1-D probe library ``f(bins, vals, leaf, ids,
    num_bins)``, wrapped as its own wrapper did: where the library has
    ``lgbt_hist_probe_1d_scratch`` (this design), an output that the
    kernel writes whole and a cached scratch; else (the parent) a zeroed
    output the kernel adds into."""
    import ctypes
    from lightgbm_tpu_torch.ops.histogram import _scratch
    fn = lib.lgbt_hist_probe_1d
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    new = hasattr(lib, "lgbt_hist_probe_1d_scratch")
    fn.argtypes = [ptr] * 4 + [i32] * 5 + [ptr] * (3 if new else 2)
    fn.restype = i32
    if new:
        lib.lgbt_hist_probe_1d_scratch.argtypes = [ptr] * 3 + [i32] * 5
        lib.lgbt_hist_probe_1d_scratch.restype = ctypes.c_longlong

    def call(bins, vals, leaf, ids, num_bins):
        F, n = bins.shape
        C, K = vals.shape[0], ids.shape[0]
        shape = (K, F, num_bins, C)
        ptrs = (bins.data_ptr(), vals.data_ptr(), leaf.data_ptr())
        stream = torch.cuda.current_stream()
        if new:
            out = torch.empty(shape, device=bins.device)
            scratch = _scratch(stream, lib.lgbt_hist_probe_1d_scratch(
                *ptrs, n, F, C, K, num_bins))
            rc = fn(*ptrs, ids.data_ptr(), n, F, C, K, num_bins,
                    scratch.data_ptr(), out.data_ptr(), stream.cuda_stream)
        else:
            out = torch.zeros(shape, device=bins.device)
            rc = fn(*ptrs, ids.data_ptr(), n, F, C, K, num_bins,
                    out.data_ptr(), stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"extra 1-D probe kernel: CUDA error {rc}")
        return out
    return call


def sass_summary(lib_path, kernels):
    """Registers, shared memory and spills of each kernel in a built
    library (``cuobjdump -res-usage``), and the atomic instructions of its
    SASS by opcode (``cuobjdump -sass``): {kernel: (usage, {opcode:
    count})}. A shared f32 add that is a compare-and-swap loop shows as
    ``ATOMS.CAST.SPIN``; a native one as ``ATOMS.ADD.F32``."""
    import re
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": ("not found", {})}
    usage = subprocess.run([tool, "-res-usage", str(lib_path)],
                           capture_output=True, text=True,
                           timeout=120).stdout
    sass = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120).stdout
    out, func = {}, None
    for line in usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            func = m.group(1)
        elif func and "REG:" in line:
            out[func] = (" ".join(line.split()), {})
    op = re.compile(r"\*/\s+(?:@!?U?P\w+\s+)?((?:ATOMS|ATOMG|ATOM|RED|REDG)"
                    r"\.[\w.]*|(?:ATOMS|ATOMG|ATOM|RED|REDG)\b)")
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            out.setdefault(func, ("", {}))
            continue
        m = op.search(line)
        if m and func:
            ops = out[func][1]
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return out


def hold_call(th, call, label, rng, exact):
    """Kernel A against its plain version on one recorded call: int mode
    bit-equal, f32 mode bit-equal on exact-sum values put in place of the
    recorded ones (``exact`` caches them by shape)."""
    bins, vals, leaf, ids = call["args"]
    kw = dict(num_bins=call["kw"]["num_bins"])
    got = th.multi_leaf_histogram(*call["args"], int_mode=True, **kw)
    ref = th.multi_leaf_histogram_plain(*call["args"], int_mode=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"{label}: int mode max |diff| "
                             f"{(got - ref).abs().max()}")
    if vals.shape not in exact:
        exact[vals.shape] = exact_f32_vals(rng, *vals.shape).to(vals.device)
    ev = exact[vals.shape]
    got = th.multi_leaf_histogram(bins, ev, leaf, ids, **kw)
    ref = th.multi_leaf_histogram_plain(bins, ev, leaf, ids, **kw)
    torch.cuda.synchronize()
    check_f32(f"{label} f32", got, ref, ev, True)


def replay_phase(dev, th, calls, extras):
    """Kernel A on every recorded call of the training phases: int mode
    bit-equal to the plain version, f32 mode bit-equal on exact-sum
    values put in place of the recorded ones; then timed in turns with
    every extra library (kernel, extras, extras, kernel), beside the
    plain version, one int and one f32 ``index_add_`` (the f32 one of
    the bf16-rounded values), the wrapper's zero-fill and cast alone,
    and the bound."""
    rng = np.random.default_rng(5)
    exact, rows, root_n = {}, [], None
    for i, call in enumerate(calls):
        bins, vals, leaf, ids = call["args"]
        B = call["kw"]["num_bins"]
        F, n = bins.shape
        C, K = vals.shape[0], ids.shape[0]
        live = torch.unique(ids[ids >= 0])
        if i == 0 or calls[i - 1]["tree"] != call["tree"]:
            kind, root_n = "root", n
        else:
            kind = "scan" if n == root_n else "spans"
        r = dict(tree=call["tree"], kind=kind, n=n, K=K,
                 live_lanes=int(live.numel()))
        kw = dict(num_bins=B)
        hold_call(th, call, f"replay {call['tree']} call {i}", rng, exact)
        for mode in ("int", "f32"):
            im = mode == "int"
            fns = {"kernel": lambda im=im: th.multi_leaf_histogram(
                bins, vals, leaf, ids, int_mode=im, **kw)}
            fns.update({name: (lambda fn=fn, im=im: extra_histogram(
                fn, bins, vals, leaf, ids, B, im))
                for name, fn in extras.items()})
            times = {name: [] for name in fns}
            for name in list(fns) + list(fns)[::-1]:
                times[name].append(time_ms(fns[name], reps=10, warmup=2))
            for name, t in times.items():
                r[f"{mode}_{name}_ms"] = sum(t) / len(t)
        r["int_plain_ms"] = time_ms(lambda: th.multi_leaf_histogram_plain(
            bins, vals, leaf, ids, int_mode=True, **kw), reps=2, warmup=1)
        zeros = torch.zeros((K, F, B, C), dtype=torch.int32, device=dev)
        r["zero_fill_ms"] = time_ms(lambda: torch.zeros(
            (K, F, B, C), dtype=torch.int32, device=dev))
        r["cast_ms"] = time_ms(lambda: zeros.to(torch.float32))
        buf = torch.zeros(K * F * B * C, dtype=torch.float32, device=dev)
        idx, src, m, pairs = lane_index(bins, vals.to(torch.bfloat16)
                                        .float(), leaf, ids, B)
        r["library_f32_ms"] = time_ms(lambda: buf.index_add_(0, idx, src),
                                      reps=5)
        src = src.to(torch.int32)
        ibuf = buf.view(torch.int32)
        r["library_int_ms"] = time_ms(lambda: ibuf.index_add_(0, idx, src),
                                      reps=5)
        del idx, src, buf, ibuf
        nbytes = 4 * n + (F + 4 * C) * m + 4 * K + 4 * K * F * B * C
        r["bound_ms"], r["bound_by"] = bound(nbytes, pairs * F * C)
        r.update(matched_rows=m, row_lane_matches=pairs)
        rows.append(r)
        print(f"replay {r['tree']} call {i} ({kind}) n={n} live lanes "
              f"{r['live_lanes']}/{K}, matched rows {m}: int kernel "
              f"{r['int_kernel_ms']:.4f} ms, f32 kernel "
              f"{r['f32_kernel_ms']:.4f} ms"
              + "".join(f", {x} {r[f'int_{x}_ms']:.4f}/{r[f'f32_{x}_ms']:.4f}"
                        f" ms" for x in extras)
              + f"; plain {r['int_plain_ms']:.3f} ms, index_add_ int "
              f"{r['library_int_ms']:.4f} / f32 {r['library_f32_ms']:.4f} "
              f"ms, zero-fill {r['zero_fill_ms']:.4f} + cast "
              f"{r['cast_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; int and "
              f"exact-sum f32 bit-equal", flush=True)
    return rows


def start_parent_builds(kernels):
    """Start one ``nvcc`` for each of ``partition.cu`` and ``compact.cu``
    under ``build/move_parent/`` (the parent's dest-driven kernels B′ and
    B, git-ignored and usually absent). Returns {name: (process, .so)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    jobs = {}
    for name in ("partition", "compact"):
        src = os.path.join(root, MOVE_PARENT_DIR, f"{name}.cu")
        if os.path.exists(src):
            so = os.path.join(root, MOVE_PARENT_DIR, f"lib{name}.so")
            jobs[name] = (subprocess.Popen(
                [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    return jobs


def finish_parent_builds(jobs):
    """Wait for ``start_parent_builds``; returns {name: C entry}."""
    import ctypes
    fns = {}
    for name, (proc, so) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {MOVE_PARENT_DIR}/{name}.cu"
                               f":\n{text}")
        lib = ctypes.CDLL(so)
        if name == "partition":
            fn = lib.lgbt_partition_move
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 4)
        else:
            fn = lib.lgbt_compact_rows
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def parent_move_step(fn, tp, bins, vals, leaf_old, leaf_new, out):
    """The parent's main-path move step: the compare, ``plan_split_move``
    and its dest-driven kernel."""
    dest, n_front, cum = tp.plan_split_move(leaf_new != leaf_old)
    F, n = bins.shape
    rc = fn(bins.data_ptr(), vals.data_ptr(), leaf_new.data_ptr(),
            dest.data_ptr(), n, F, vals.shape[0], out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent partition kernel: CUDA error {rc}")
    return out, n_front, cum


def parent_compact_step(fn, tc, bins, vals, keep, out_cols, R):
    """The parent's main-path compaction step: ``plan_compaction``, two
    zero-filled outputs and its dest-driven kernel."""
    dest, aligned, rem = tc.plan_compaction(keep, R, out_cols)
    F, n = bins.shape
    C = vals.shape[0]
    ob = torch.zeros((F, out_cols), dtype=torch.uint8, device=bins.device)
    ov = torch.zeros((C, out_cols), dtype=torch.float32, device=bins.device)
    rc = fn(bins.data_ptr(), vals.data_ptr(), dest.data_ptr(),
            aligned.data_ptr(), rem.data_ptr(), n, F, C, R, out_cols,
            ob.data_ptr(), ov.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent compaction kernel: CUDA error {rc}")
    return ob, ov


def in_turns(fns, reps=20):
    """Time each callable in turns (order, then reversed), on the device
    (``device_ms``) and per call as the host sees it back to back
    (``time_ms``): ({name: mean device ms}, {name: mean call ms},
    {name: [device ms, ...]})."""
    dev_t = {x: [] for x in fns}
    call_t = {x: [] for x in fns}
    for x in list(fns) + list(fns)[::-1]:
        dev_t[x].append(device_ms(fns[x], reps=reps))
        call_t[x].append(time_ms(fns[x], reps=reps))
    return ({x: sum(t) / len(t) for x, t in dev_t.items()},
            {x: sum(t) / len(t) for x, t in call_t.items()}, dev_t)


def same_bits(a, b):
    """Bit equality of two tensors of one dtype (f32 compared as int32)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def compaction_phase(dev, tc, parent):
    """Kernel B (``compact_by_mask``) at the GOSS flagship's shape (its
    padded rows, keep fraction 0.3 into the 311,296-column buffer) and at
    one edge fraction: bit-equal to the plain version over REPEATS
    launches, then timed in turns with the parent's whole main-path step
    (``plan_compaction``, two zero-fills and its kernel) when
    ``build/move_parent/compact.cu`` is there, beside the plain version
    and a mask select."""
    n, F, C, R = 1_003_520, 28, 4, 1024
    rng = np.random.default_rng(2)
    bins = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                            .astype(np.uint8)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32)) \
        .to(dev)
    out = {}
    for label, frac in (("goss", 0.3), ("edge", 0.001)):
        keep = torch.from_numpy(rng.uniform(size=n) < frac).to(dev)
        k = int(keep.sum())
        out_cols = (311_296 if label == "goss"
                    else tc.compaction_out_cols(k, R, 4096))
        pb, pv = tc.compact_by_mask_plain(bins, vals, keep, out_cols)
        got = [tc.compact_by_mask(bins, vals, keep, out_cols)
               for _ in range(REPEATS)]
        torch.cuda.synchronize()
        bad = [i for i, (gb, gv) in enumerate(got)
               if not (same_bits(gb, pb) and same_bits(gv, pv))]
        if bad:
            raise AssertionError(f"compaction {label}: launches {bad} of "
                                 f"{REPEATS} differ from the plain version")
        del got
        fns = {"kernel": lambda: tc.compact_by_mask(bins, vals, keep,
                                                    out_cols)}
        if "compact" in parent:
            ob, ov = parent_compact_step(parent["compact"], tc, bins, vals,
                                         keep, out_cols, R)
            if not (same_bits(ob, pb) and same_bits(ov, pv)):
                raise AssertionError(f"compaction {label}: the parent's "
                                     "step differs from the plain version")
            fns["parent_step"] = lambda: parent_compact_step(
                parent["compact"], tc, bins, vals, keep, out_cols, R)
        ms, call_ms, turns = in_turns(fns)
        plain_ms = time_ms(lambda: tc.compact_by_mask_plain(
            bins, vals, keep, out_cols), reps=5)
        lib_ms = time_ms(lambda: (bins[:, keep], vals[:, keep]), reps=5)
        # the mask, the kept columns read once, the whole output (its tail
        # is zeros) written once
        nbytes = n + (F + 4 * C) * k + (F + 4 * C) * out_cols
        b_ms, b_by = bound(nbytes, 0)
        out[label] = dict(n=n, kept=k, out_cols=out_cols, ms=ms["kernel"],
                          earlier_ms=ms.get("parent_step"),
                          call_ms=call_ms["kernel"],
                          earlier_call_ms=call_ms.get("parent_step"),
                          turns=turns, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
        print(f"compaction {label} n={n} keep={k} out_cols={out_cols}: "
              f"device ms: compact_by_mask {ms['kernel']:.4f}"
              + (f", parent step (plan + zero-fills + kernel) "
                 f"{ms['parent_step']:.4f}, parent / kernel "
                 f"{ms['parent_step'] / ms['kernel']:.2f}"
                 if "parent_step" in ms else "")
              + f" (in turns {turns}); per call back to back: "
              + ", ".join(f"{x} {t:.4f}" for x, t in call_ms.items())
              + f"; plain {plain_ms:.3f} ms, mask select {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms; {REPEATS} launches bit-equal",
              flush=True)
    return out


def move_case(rng, n, frac, dev):
    """Old and new leaf ids of one split batch: a fraction ``frac`` of
    the positions changes its id."""
    old = rng.integers(0, 127, size=n).astype(np.int32)
    new = np.where(rng.uniform(size=n) < frac, old + 127, old)
    return (torch.from_numpy(old).to(dev),
            torch.from_numpy(new.astype(np.int32)).to(dev))


def partition_phase(dev, tp, n, parent):
    """Kernel B′ (``partition_move``) at the full-row run's padded width:
    the reference probe's worst moved fraction (0.5) and a sparse one.
    Bit-equal to the plain version (columns, cum, n_front) over REPEATS
    launches, then timed in turns with the parent's whole main-path step
    (the compare, ``plan_split_move`` and its kernel) when
    ``build/move_parent/partition.cu`` is there, beside the plain version
    and three ``index_copy_``."""
    F, C = HIST_F, HIST_C
    rng = np.random.default_rng(3)
    bins = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                            .astype(np.uint8)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32)) \
        .to(dev)
    res = {}
    for label, frac in (("half", 0.5), ("sparse", 0.001)):
        old, new = move_case(rng, n, frac, dev)
        (pb, pv, pl), pnf, pcum = tp.partition_move_plain(bins, vals, old,
                                                          new)
        outs = [tuple(torch.empty_like(a) for a in (bins, vals, new))
                for _ in range(2)]
        bad = []
        for i in range(REPEATS):
            (kb, kv, kl), knf, kcum = tp.partition_move(
                bins, vals, old, new, out=outs[i % 2])
            torch.cuda.synchronize()
            if not (same_bits(kb, pb) and same_bits(kv, pv)
                    and same_bits(kl, pl) and same_bits(kcum, pcum)
                    and int(knf) == int(pnf)):
                bad.append(i)
        if bad:
            raise AssertionError(f"partition move {label}: launches {bad} "
                                 f"of {REPEATS} differ from the plain "
                                 "version")
        out = outs[0]
        fns = {"kernel": lambda: tp.partition_move(bins, vals, old, new,
                                                   out=out)}
        if "partition" in parent:
            (ob, ov, ol), _, _ = parent_move_step(parent["partition"], tp,
                                                  bins, vals, old, new,
                                                  outs[1])
            if not (same_bits(ob, pb) and same_bits(ov, pv)
                    and same_bits(ol, pl)):
                raise AssertionError(f"partition move {label}: the "
                                     "parent's step differs from the plain"
                                     " version")
            fns["parent_step"] = lambda: parent_move_step(
                parent["partition"], tp, bins, vals, old, new, out)
        ms, call_ms, turns = in_turns(fns)
        plain_ms = time_ms(lambda: tp.partition_move_plain(
            bins, vals, old, new), reps=5)
        # library yardstick: one index_copy_ per array, dest computed
        # beforehand
        d64 = tp.plan_split_move(new != old)[0].long()
        lib_ms = device_ms(lambda: (out[0].index_copy_(1, d64, bins),
                                    out[1].index_copy_(1, d64, vals),
                                    out[2].index_copy_(0, d64, new)),
                           reps=5)
        # both leaf-id arrays, every column read once and written once,
        # cum written once
        nbytes = n * ((F + 4 * C + 8) + (F + 4 * C + 4) + 4)
        b_ms, b_by = bound(nbytes, 0)
        res[label] = dict(n=n, moved=int((new != old).sum()),
                          ms=ms["kernel"], earlier_ms=ms.get("parent_step"),
                          call_ms=call_ms["kernel"],
                          earlier_call_ms=call_ms.get("parent_step"),
                          turns=turns, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
        print(f"partition move {label} n={n} moved={res[label]['moved']}: "
              f"device ms: partition_move {ms['kernel']:.4f}"
              + (f", parent step (compare + plan + kernel) "
                 f"{ms['parent_step']:.4f}, parent / kernel "
                 f"{ms['parent_step'] / ms['kernel']:.2f}"
                 if "parent_step" in ms else "")
              + f" (in turns {turns}); per call back to back: "
              + ", ".join(f"{x} {t:.4f}" for x, t in call_ms.items())
              + f"; plain {plain_ms:.3f} ms, index_copy_ {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms; {REPEATS} launches bit-equal",
              flush=True)
    return res


def probe_phase(dev, hp, th, nibble_extras, nibble_usage, probe_extras):
    """The two probe kernels at their probe shapes, each held against the
    plain version (within the f32 tolerance, and bit for bit on exact-sum
    inputs) and timed beside kernel A in f32 mode. The 1-D probe is timed
    in turns with kernel A and every ``probe1d_*`` source under
    ``build/hist_extra/`` (the parent's ``hist_probes.cu``, the other
    design of the adds, stripped copies: timed, not checked), as device
    time and per call (``in_turns``); its passes are printed, and the
    split of its time that the stripped copies give (PROBE_1D_SPLIT).
    The nibble probe is timed in turns (kernel, extras, extras, kernel)
    with every nibble-probe source there (an earlier ``hist_probes.cu``
    or a stripped copy) at each nb, and its launch plan and registers
    (``nibble_usage``) are printed per nb. The probes are on no training
    path: their launches count this phase's checked calls (two per shape,
    and per nb for the nibble probe)."""
    res, launches = {}, {}
    for label, (name, F, n, B, K, C, leaves) in PROBE_SHAPES.items():
        rng = np.random.default_rng(4)
        bins = torch.from_numpy(rng.integers(0, 255, size=(F, n))
                                .astype(np.uint8)).to(dev)
        vals = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32)) \
            .to(dev)
        exact = exact_f32_vals(rng, C, n).to(dev)
        if leaves == "lane0":
            leaf = torch.zeros(n, dtype=torch.int32, device=dev)
        else:
            leaf = torch.from_numpy(rng.integers(0, K, size=n)
                                    .astype(np.int32)).to(dev)
        ids = torch.arange(K, dtype=torch.int32, device=dev)
        if name == "hist_probe_1d":
            variants = {"probe": lambda v: hp.hist_probe_1d(
                bins, v, leaf, ids, num_bins=B)}
        else:
            variants = {f"nb{nb}": (lambda v, nb=nb: hp.hist_probe_nibble(
                bins, v, leaf, ids, num_bins=B, nb=nb))
                for nb in hp.NIBBLE_WIDTHS}
        variants["kernel_a"] = lambda v: th.multi_leaf_histogram(
            bins, v, leaf, ids, num_bins=B)
        r = {tag: {} for tag in variants}
        before = getattr(hp, name).launches
        for v, is_exact in ((vals, False), (exact, True)):
            ref = th.multi_leaf_histogram_plain(bins, v, leaf, ids,
                                                num_bins=B)
            for tag, fn in variants.items():
                got = fn(v)
                torch.cuda.synchronize()
                err = check_f32(f"{label} {tag}", got, ref, v, is_exact)
                if not is_exact:
                    r[tag]["max_abs_err"] = err
        # the checked calls of every shape of the probe
        launches[name] = (launches.get(name, 0)
                          + getattr(hp, name).launches - before)
        plain_ms = time_ms(lambda: th.multi_leaf_histogram_plain(
            bins, vals, leaf, ids, num_bins=B), reps=3, warmup=1)
        # library yardstick: one index_add_ into the flat [K*F*B*C]
        # buffer of the bf16-rounded values, its index built beforehand
        idx, src, m, pairs = lane_index(
            bins, vals.to(torch.bfloat16).float(), leaf, ids, B)
        buf = torch.zeros(K * F * B * C, dtype=torch.float32, device=dev)
        lib_ms = time_ms(lambda: buf.index_add_(0, idx, src), reps=5)
        del idx, src
        nbytes = 4 * n + (F + 4 * C) * m + 4 * K * F * B * C
        b_ms, b_by = bound(nbytes, pairs * F * C)
        if name == "hist_probe_1d":
            fns = {"kernel": variants["probe"],
                   "kernel_a": variants["kernel_a"]}
            fns.update({x: (lambda v, fn=fn: fn(bins, v, leaf, ids, B))
                        for x, fn in probe_extras.items()})
            ms, call_ms, turns = in_turns({x: (lambda fn=fn: fn(vals))
                                           for x, fn in fns.items()})
            plan = hp.probe_1d_plan(bins, vals, leaf, ids, num_bins=B)
            t = ms["kernel"]
            r["probe"].update(ms=t, call_ms=call_ms["kernel"], turns=turns,
                              earlier_ms=ms.get(PROBE_1D_EXTRA + "parent"),
                              extras_ms={x: ms[x] for x in probe_extras},
                              extras_call_ms={x: call_ms[x]
                                              for x in probe_extras},
                              plan=plan)
            r["kernel_a"].update(ms=ms["kernel_a"],
                                 call_ms=call_ms["kernel_a"])
            split = None
            if all(x in ms for x in PROBE_1D_SPLIT):
                no_adds, no_red, neither = (ms[x] for x in PROBE_1D_SPLIT)
                split = dict(adds=t - no_adds, reduction=t - no_red,
                             rest=neither)
                r["probe"]["split_ms"] = split
            print(f"{label} F={F} n={n} B={B} K={K} C={C} ({leaves}): "
                  f"passes {plan}; device ms in turns: kernel {t:.4f}, "
                  f"kernel A {ms['kernel_a']:.4f} (kernel / kernel A "
                  f"{t / ms['kernel_a']:.3f})" + "".join(
                      f", {x} {ms[x]:.4f} ({x} / kernel {ms[x] / t:.3f})"
                      for x in probe_extras)
                  + f" {turns}; per call: " + ", ".join(
                      f"{x} {c:.4f}" for x, c in call_ms.items())
                  + (f"; split (stripped copies): adds {split['adds']:.4f},"
                     f" reduction {split['reduction']:.4f}, the rest "
                     f"(loads, slot lookups, zeroing, partial writes, "
                     f"barrier) {split['rest']:.4f}" if split else "")
                  + f"; index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"(half its rate: {2 * b_ms:.4f} ms, reached "
                  f"{t <= 2 * b_ms})", flush=True)
        else:
            r["kernel_a"]["ms"] = time_ms(lambda: variants["kernel_a"](vals))
            for nb in hp.NIBBLE_WIDTHS:
                tag = f"nb{nb}"
                fns = {"kernel": lambda nb=nb: hp.hist_probe_nibble(
                    bins, vals, leaf, ids, num_bins=B, nb=nb)}
                for x, fn in nibble_extras.items():
                    fns[x] = (lambda fn=fn, nb=nb: extra_nibble(
                        fn, bins, vals, leaf, ids, B, nb))
                times = {x: [] for x in fns}
                for x in list(fns) + list(fns)[::-1]:
                    times[x].append(time_ms(fns[x]))
                ms = {x: sum(t) / len(t) for x, t in times.items()}
                plan = hp.nibble_plan(bins, vals, leaf, ids, num_bins=B,
                                      nb=nb)
                r[tag].update(ms=ms.pop("kernel"), turns=times,
                              earlier_ms=ms, plan=plan)
                print(f"{name} nb={nb}: cluster {plan['cluster']} CTAs, "
                      f"tile w={plan['w']} bins, "
                      f"{plan['pairs_per_chunk']} (feature, group) pairs "
                      f"= up to {plan['features_per_chunk']} features per "
                      f"chunk, {plan['chunks']} chunks on "
                      f"{plan['clusters']} clusters (resident "
                      f"{plan['resident_clusters']}), passes per cluster "
                      f"{-(-plan['chunks'] // plan['clusters'])}, CTAs "
                      f"{plan['clusters'] * plan['cluster']}, shared "
                      f"memory per CTA {plan['smem_per_cta']} B, rows per "
                      f"CTA {plan['rows_per_cta']}; registers "
                      f"{nibble_usage}; in turns: kernel "
                      f"{r[tag]['ms']:.4f} ms " + "".join(
                          f"({x} {t:.4f} ms, {x} / kernel "
                          f"{t / r[tag]['ms']:.3f}) " for x, t in ms.items())
                      + f"{times}; index_add_ {lib_ms:.4f} ms, kernel A "
                      f"f32 {r['kernel_a']['ms']:.4f} ms, bound "
                      f"{b_ms:.4f} ms", flush=True)
        res[label] = dict(F=F, n=n, B=B, K=K, C=C, leaves=leaves,
                          matched_rows=m, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                          variants=r)
        print(f"{label} F={F} n={n} B={B} K={K} C={C}: " + ", ".join(
            f"{t} {v['ms']:.4f} ms" for t, v in r.items())
            + f" (plain {plain_ms:.2f} ms, index_add_ {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms); exact-sum inputs bit-equal", flush=True)
    res["launches"] = launches
    return res


def trace_rounds(bst, rounds):
    """``rounds`` more iterations under ``torch.profiler``: wall and
    device-busy ms per iteration (the union of the device's kernel and
    copy intervals), the idle share, the device ms of the move and
    compaction kernels (``STEP_KERNELS``), device-to-host copies per
    iteration (the host's blocking reads) and the kernels with the most
    device time. The profiler's own host overhead is in the wall time. Device
    numbers are None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(rounds):
            bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / rounds
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end_us, per_name = 0.0, -math.inf, {}
    for e in sorted(dev_ev, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        busy_us += max(0.0, b - max(a, end_us))
        end_us = max(end_us, b)
        per_name[e.name] = per_name.get(e.name, 0.0) + (b - a)
    if not dev_ev:
        return dict(wall_ms_per_iter=wall_ms, busy_ms_per_iter=None,
                    idle_share=None, step_ms_per_iter=None,
                    dtoh_per_iter=None, top_kernels=None)
    busy_ms = busy_us / 1e3 / rounds
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    step = {k: sum(us for name, us in per_name.items() if k in name)
            / 1e3 / rounds for k in STEP_KERNELS}
    return dict(
        wall_ms_per_iter=wall_ms, busy_ms_per_iter=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, step_ms_per_iter=step,
        dtoh_per_iter=sum("DtoH" in e.name or "Device -> Host" in e.name
                          for e in dev_ev) / rounds,
        top_kernels=[(name[:80], us / 1e3 / rounds) for name, us in top])


def full_row_phase(lgt, th, tc, tp, n_pad, rec, extras):
    """Full-row training at 2M rows, the partition off and forced on;
    ``rec`` records the histogram calls of one more tree of each run.
    With an extra histogram named ``parent`` (``build/hist_extra/``),
    the masked run is then repeated with kernel A and with it in turns
    (kernel, parent, parent, kernel): it/s of both in one call."""
    X, y = synth_higgs(N_FULL + N_HOLDOUT, N_FEAT, seed=0)
    Xv, yv = X[N_FULL:], y[N_FULL:]
    t0 = time.time()
    ds = lgt.Dataset(X[:N_FULL], label=y[:N_FULL])
    vs = ds.create_valid(Xv, label=yv)
    runs = {}
    for mode in ("false", "true"):
        bst = lgt.Booster(params=dict(FULL_PARAMS, tpu_hist_partition=mode),
                          train_set=ds)
        bst.add_valid(vs, "holdout")
        eng = bst.engine
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        if eng.data.n_pad != n_pad or eng.hist_partition != (mode == "true"):
            raise AssertionError(f"full-row {mode}: n_pad {eng.data.n_pad}, "
                                 f"partition {eng.hist_partition}")
        if not eng.grow_cfg.int_hist:
            raise AssertionError("full-row run is not on quantized gradients")
        # this path: counts from 0 just before, read just after
        th.multi_leaf_histogram.launches = 0
        tc.compact_by_mask.launches = 0
        tp.partition_move.launches = 0
        per_iter, secs = [], []
        for _ in range(ROUNDS):
            m0 = tp.partition_move.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            per_iter.append(tp.partition_move.launches - m0)
        launches = {"histogram": th.multi_leaf_histogram.launches,
                    "compact": tc.compact_by_mask.launches,
                    "partition": tp.partition_move.launches}
        [(_, _, auc, _)] = bst.eval_valid()
        runs[mode] = dict(
            auc=auc, it_per_s=ROUNDS / sum(secs), first_iter_s=secs[0],
            hist_rows_scanned=eng.hist_rows_scanned, launches=launches,
            move_launches_per_iter=per_iter, setup_s=setup_s,
            text=bst.model_to_string())
        print(f"full-row partition={mode}: {ROUNDS} rounds, "
              f"{runs[mode]['it_per_s']:.3f} it/s (first iteration "
              f"{secs[0]:.3f} s), holdout AUC {auc:.6f}, rows scanned "
              f"{eng.hist_rows_scanned:.0f}, launches {launches}, "
              f"partition_move launches per iteration {per_iter}, "
              f"setup {setup_s:.2f} s", flush=True)
        # after the checked rounds: a traced pass for the idle share
        tr = runs[mode]["trace"] = trace_rounds(bst, TRACE_ROUNDS)
        print(f"full-row partition={mode} traced ({TRACE_ROUNDS} more "
              f"iterations): {tr['wall_ms_per_iter']:.2f} ms wall, "
              f"device busy {tr['busy_ms_per_iter']} ms, idle share "
              f"{tr['idle_share']}, device ms per iteration of the move "
              f"and compaction kernels {tr['step_ms_per_iter']}, "
              f"device-to-host copies per iteration "
              f"{tr['dtoh_per_iter']}; top device time (ms per "
              f"iteration): {tr['top_kernels']}", flush=True)
        if (tr["dtoh_per_iter"] or 0) > MAX_DTOH[mode]:
            raise AssertionError(f"full-row partition={mode}: "
                                 f"{tr['dtoh_per_iter']} device-to-host "
                                 f"copies per iteration, more than "
                                 f"{MAX_DTOH[mode]}")
        # after the trace: record one more tree's histogram calls; with
        # the partition, the first of up to SPAN_SEARCH more trees that
        # has a span round
        for i in range(SPAN_SEARCH):
            first = len(rec.calls)
            rec.tag = f"full_row_{mode}"
            bst.update()
            rec.tag = None
            tree = rec.calls[first:]
            if mode == "false" or any(
                    c["args"][0].shape[1] != tree[0]["args"][0].shape[1]
                    for c in tree) or i == SPAN_SEARCH - 1:
                break
            del rec.calls[first:]
        t0 = time.time()
    if "parent" in extras:
        fn = extras["parent"]
        ab = {"kernel": [], "parent": []}
        for tag in ("kernel", "parent", "parent", "kernel"):
            rec.impl = None if tag == "kernel" else (
                lambda b, v, l, k, num_bins, int_mode: extra_histogram(
                    fn, b, v, l, k, num_bins, int_mode))
            bst = lgt.Booster(params=dict(FULL_PARAMS,
                                          tpu_hist_partition="false"),
                              train_set=ds)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(ROUNDS):
                bst.update()
            torch.cuda.synchronize()
            ab[tag].append(ROUNDS / (time.perf_counter() - t))
            if bst.model_to_string() != runs["false"]["text"]:
                raise AssertionError(f"full-row A/B: {tag} model text "
                                     "differs")
        rec.impl = None
        runs["false"]["it_per_s_ab"] = ab
        print(f"full-row partition=false, it/s in turns (kernel, parent, "
              f"parent, kernel), {ROUNDS} rounds each, model text "
              f"byte-equal: kernel {ab['kernel']}, parent {ab['parent']}",
              flush=True)
    off, on = runs["false"], runs["true"]
    if off["launches"]["histogram"] <= 0 or on["launches"]["histogram"] <= 0:
        raise AssertionError("full-row path skipped kernel A")
    if off["launches"]["partition"] != 0 or min(
            on["move_launches_per_iter"]) < 1:
        raise AssertionError(f"partition move launches per iteration: "
                             f"off {off['move_launches_per_iter']}, on "
                             f"{on['move_launches_per_iter']}")
    if on["text"] != off["text"]:
        raise AssertionError("model text differs with the partition on")
    if not on["hist_rows_scanned"] < off["hist_rows_scanned"]:
        raise AssertionError("the partition did not scan fewer rows")
    for r in runs.values():
        if not (r["auc"] > 0.85 and math.isfinite(r["it_per_s"])):
            raise AssertionError(f"full-row run: AUC {r['auc']}, it/s "
                                 f"{r['it_per_s']}")
    return {mode: {k: v for k, v in r.items() if k != "text"}
            for mode, r in runs.items()}


def partition_sweep_phase(lgt, tp):
    """The partition's speed policy (``tpu_hist_partition=auto``): full-row
    training with the partition off and forced on
    (``tpu_hist_partition=true``) in turns (off, on, on, off),
    SWEEP_ROUNDS rounds a run, at each of SWEEP_ROWS rows: it/s over all
    rounds and over all but the first, rows scanned, ``partition_move``
    launches (counted from 0 for each run), model text byte-equal across
    the four runs."""
    res = {}
    for n in SWEEP_ROWS:
        t0 = time.time()
        X, y = synth_higgs(n, N_FEAT, seed=0)
        ds = lgt.Dataset(X, label=y)
        del X
        runs, texts = {"false": [], "true": []}, set()
        for mode in ("false", "true", "true", "false"):
            bst = lgt.Booster(params=dict(FULL_PARAMS,
                                          tpu_hist_partition=mode),
                              train_set=ds)
            eng = bst.engine
            if eng.hist_partition != (mode == "true"):
                raise AssertionError(f"sweep n={n} {mode}: partition "
                                     f"{eng.hist_partition}")
            tp.partition_move.launches = 0
            secs = []
            for _ in range(SWEEP_ROUNDS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                bst.update()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            runs[mode].append(dict(
                it_per_s=len(secs) / sum(secs),
                it_per_s_after_first=(len(secs) - 1) / sum(secs[1:]),
                first_iter_s=secs[0], rows_scanned=eng.hist_rows_scanned,
                move_launches=tp.partition_move.launches))
            texts.add(bst.model_to_string())
            del bst, eng
        if len(texts) != 1:
            raise AssertionError(f"sweep n={n}: model text differs between "
                                 "the runs")
        res[n] = dict(runs, seconds=time.time() - t0)
        print(f"partition sweep n={n}, {SWEEP_ROUNDS} rounds a run, in turns"
              f" (off, on, on, off), model text byte-equal: " + "; ".join(
                  f"{mode} it/s {[round(r['it_per_s'], 3) for r in rs]} "
                  f"(after the first iteration "
                  f"{[round(r['it_per_s_after_first'], 3) for r in rs]}), "
                  f"rows scanned {rs[0]['rows_scanned']:.0f}, "
                  f"partition_move launches {rs[0]['move_launches']}"
                  for mode, rs in runs.items())
              + f"; phase {res[n]['seconds']:.1f} s", flush=True)
    return res


def train_phase(lgt, th, tc, tp, rec):
    """The GOSS flagship; ``rec`` records the histogram calls of the last
    full-row tree and of the last (GOSS) tree."""
    X, y = synth_higgs(N_TRAIN + N_HOLDOUT, N_FEAT, seed=0)
    Xt, yt = X[:N_TRAIN], y[:N_TRAIN]
    Xv, yv = X[N_TRAIN:], y[N_TRAIN:]
    t0 = time.time()
    ds = lgt.Dataset(Xt, label=yt)
    vs = ds.create_valid(Xv, label=yv)
    bst = lgt.Booster(params=dict(PARAMS), train_set=ds)
    bst.add_valid(vs, "holdout")
    torch.cuda.synchronize()
    print(f"train setup (binning + upload): {time.time() - t0:.2f} s",
          flush=True)
    eng = bst.engine
    if not eng.use_goss_compact:
        raise AssertionError("the GOSS compacted buffer is not engaged")
    # the main path: counts from 0 just before, read just after
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    per_iter, secs = [], []
    goss_start = int(1.0 / PARAMS["learning_rate"])
    for i in range(ROUNDS):
        h0 = th.multi_leaf_histogram.launches
        c0 = tc.compact_by_mask.launches
        goss = eng.goss_active()
        rec.tag = ("goss_flagship_full_row" if i == goss_start - 1
                   else "goss_flagship_goss" if i == ROUNDS - 1 else None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append((goss, time.perf_counter() - t))
        rec.tag = None
        per_iter.append((th.multi_leaf_histogram.launches - h0,
                         tc.compact_by_mask.launches - c0))
    launches = {"histogram": th.multi_leaf_histogram.launches,
                "compact": tc.compact_by_mask.launches,
                "partition": tp.partition_move.launches}
    masked_s = [s for g, s in secs if not g]
    goss_s = [s for g, s in secs if g]
    if launches["histogram"] <= 0 or launches["compact"] <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if [c for _, c in per_iter] != [0] * len(masked_s) + [1] * len(goss_s):
        raise AssertionError(f"compaction launches per iteration "
                             f"{per_iter}")
    if min(h for h, _ in per_iter) < 2:
        raise AssertionError(f"histogram launches per iteration "
                             f"{per_iter}")
    [(_, _, auc, _)] = bst.eval_valid()
    pred = bst.predict(Xv)
    if not (np.isfinite(pred).all() and pred.shape == (N_HOLDOUT,)):
        raise AssertionError("holdout predictions are not finite")
    if auc <= 0.85:
        raise AssertionError(f"holdout AUC {auc} <= 0.85")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        back = lgt.Booster(model_file=path).predict(Xv)
    rt = float(np.abs(back - pred).max())
    if rt > 1e-6:
        raise AssertionError(f"model text round trip max |diff| {rt}")
    res = dict(auc=auc, roundtrip_max_diff=rt,
               masked_it_per_s=len(masked_s) / sum(masked_s),
               goss_it_per_s=len(goss_s) / sum(goss_s),
               first_iter_s=secs[0][1], iter_s=[s for _, s in secs],
               per_iter_launches=per_iter,
               launches=launches, trees_leaves=[t.num_leaves
                                                for t in eng.models])
    print(f"train: {ROUNDS} rounds ({len(masked_s)} full-row, "
          f"{len(goss_s)} GOSS); holdout AUC {auc:.6f}; full-row "
          f"{res['masked_it_per_s']:.3f} it/s (first iteration "
          f"{secs[0][1]:.3f} s), GOSS {res['goss_it_per_s']:.3f} it/s; "
          f"model-text round trip max |diff| {rt:.3g}", flush=True)
    print(f"kernel launches per iteration (histogram, compaction): "
          f"{per_iter}; seconds per iteration "
          f"{[round(s, 4) for _, s in secs]}", flush=True)
    # after the checks: a traced pass over more GOSS iterations
    tr = res["trace"] = trace_rounds(bst, TRACE_ROUNDS)
    print(f"train GOSS traced ({TRACE_ROUNDS} more iterations): "
          f"{tr['wall_ms_per_iter']:.2f} ms wall, device busy "
          f"{tr['busy_ms_per_iter']} ms, idle share {tr['idle_share']}, "
          f"device ms per iteration of the move and compaction kernels "
          f"{tr['step_ms_per_iter']}, device-to-host copies per iteration "
          f"{tr['dtoh_per_iter']}", flush=True)
    return res


class ModeCounter:
    """Counts the grow loop's kernel-A calls by mode (int / f32). It takes
    the place of the name the grow loop calls and passes every call on to
    the wrapper, whose own count is the launch count."""

    def __init__(self, serial, th):
        self.serial, self.th = serial, th
        self.prev = serial.multi_leaf_histogram
        self.calls = {"int": 0, "f32": 0}
        serial.multi_leaf_histogram = self

    def __call__(self, bins_t, vals_t, leaf_id, small_ids, **kw):
        self.calls["int" if kw.get("int_mode") else "f32"] += 1
        return self.prev(bins_t, vals_t, leaf_id, small_ids, **kw)

    def close(self):
        self.serial.multi_leaf_histogram = self.prev


def trace_line(name, tr):
    print(f"objectives: {name} traced ({TRACE_ROUNDS} more iterations): "
          f"{tr['wall_ms_per_iter']:.2f} ms wall, device busy "
          f"{tr['busy_ms_per_iter']} ms, idle share {tr['idle_share']}, "
          f"device-to-host copies per iteration {tr['dtoh_per_iter']}; top "
          f"device time (ms per iteration): {tr['top_kernels']}",
          flush=True)


def split_lines(text):
    return [ln for ln in text.splitlines()
            if ln.split("=", 1)[0] in SPLIT_KEYS]


def timed_rounds(bst, rounds, th, tp):
    """``rounds`` iterations from counts of 0: seconds and kernel A / B′
    launches per iteration, and the launches of the whole run."""
    th.multi_leaf_histogram.launches = 0
    tp.partition_move.launches = 0
    secs, hist, move = [], [], []
    for _ in range(rounds):
        h0, m0 = th.multi_leaf_histogram.launches, tp.partition_move.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        hist.append(th.multi_leaf_histogram.launches - h0)
        move.append(tp.partition_move.launches - m0)
    return dict(secs=secs, it_per_s=rounds / sum(secs),
                it_per_s_after_first=(rounds - 1) / sum(secs[1:]),
                hist_per_iter=hist, move_per_iter=move,
                launches={"histogram": th.multi_leaf_histogram.launches,
                          "partition": tp.partition_move.launches})


def regression_run(lgt, th, tp, modes, smi):
    """L2 regression on 2M Higgs-shaped rows (the label is the logit plus
    noise), partition off and forced on: auto-quantized (kernel A in int
    mode), B′ every iteration with the partition, model text byte-equal,
    holdout l2 below the label's variance."""
    X, y = synth_higgs(N_REG + N_HOLDOUT, N_FEAT, seed=1, regression=True)
    ds = lgt.Dataset(X[:N_REG], label=y[:N_REG])
    vs = ds.create_valid(X[N_REG:], label=y[N_REG:])
    var = float(np.var(y[N_REG:]))
    del X
    runs, texts = {}, {}
    for mode in ("false", "true"):
        bst = lgt.Booster(params=dict(FULL_PARAMS, objective="regression",
                                      metric="l2", tpu_hist_partition=mode),
                          train_set=ds)
        bst.add_valid(vs, "holdout")
        eng = bst.engine
        if not (eng.grow_cfg.int_hist and eng.num_class == 1
                and eng.hist_partition == (mode == "true")):
            raise AssertionError(f"regression {mode}: int_hist "
                                 f"{eng.grow_cfg.int_hist}, partition "
                                 f"{eng.hist_partition}")
        c0 = dict(modes.calls)
        r = timed_rounds(bst, REG_ROUNDS, th, tp)
        r["modes"] = {k: modes.calls[k] - c0[k] for k in c0}
        [(_, _, l2, _)] = bst.eval_valid()
        r.update(l2=l2, label_var=var)
        texts[mode] = bst.model_to_string()
        r["trace"] = trace_rounds(bst, TRACE_ROUNDS)
        runs[mode] = r
        print(f"objectives: regression (L2) n={N_REG} partition={mode}: "
              f"{REG_ROUNDS} rounds, {r['it_per_s']:.3f} it/s (after the "
              f"first iteration {r['it_per_s_after_first']:.3f}) on {smi}; "
              f"holdout l2 {l2:.6f} against the label's variance "
              f"{var:.6f}; kernel A launches per iteration "
              f"{r['hist_per_iter']} (by mode {r['modes']}), B′ "
              f"{r['move_per_iter']}", flush=True)
        trace_line(f"regression partition={mode}", r["trace"])
        if not l2 < var:
            raise AssertionError(f"regression holdout l2 {l2} against the "
                                 f"label's variance {var}")
        if r["modes"]["f32"] or min(r["hist_per_iter"]) < 2:
            raise AssertionError(f"regression kernel A calls {r}")
    if min(runs["true"]["move_per_iter"]) < 1 \
            or runs["false"]["launches"]["partition"]:
        raise AssertionError("regression: B′ launches per iteration off "
                             f"{runs['false']['move_per_iter']}, on "
                             f"{runs['true']['move_per_iter']}")
    if texts["true"] != texts["false"]:
        raise AssertionError("regression: model text differs with the "
                             "partition on")
    return runs


def multiclass_run(lgt, th, tp, modes, smi):
    """Multiclass softmax, 7 classes, at the Covertype shape: 7 trees an
    iteration, auto-quantized (kernel A in int mode, 9 calls a tree)."""
    X, y = synth_covtype(N_COVTYPE + N_COVTYPE_HOLDOUT, seed=0)
    Xt, yt = X[:N_COVTYPE], y[:N_COVTYPE]
    Xv, yv = X[N_COVTYPE:], y[N_COVTYPE:]
    K = len(COVTYPE_SHARES)
    ds = lgt.Dataset(Xt, label=yt)
    bst = lgt.Booster(params=dict(FULL_PARAMS, objective="multiclass",
                                  num_class=K, tpu_hist_partition="false",
                                  metric=["multi_logloss", "multi_error"]),
                      train_set=ds)
    bst.add_valid(ds.create_valid(Xv, label=yv), "holdout")
    eng = bst.engine
    if not (eng.grow_cfg.int_hist and eng.num_class == K):
        raise AssertionError(f"multiclass: int_hist {eng.grow_cfg.int_hist}"
                             f", K {eng.num_class}")
    c0 = dict(modes.calls)
    r = timed_rounds(bst, MC_ROUNDS, th, tp)
    r["modes"] = {k: modes.calls[k] - c0[k] for k in c0}
    ev = {m: v for _, m, v, _ in bst.eval_valid()}
    shares = np.bincount(yt.astype(np.int64), minlength=K) / len(yt)
    prior_logloss = float(-np.sum(shares * np.log(shares)))
    r.update(multi_logloss=ev["multi_logloss"],
             multi_error=ev["multi_error"], prior_logloss=prior_logloss,
             trees=len(eng.models))
    pred = bst.predict(Xv)
    print(f"objectives: multiclass K={K} n={N_COVTYPE} x "
          f"{Xt.shape[1]} (Covertype-shaped): {MC_ROUNDS} rounds, "
          f"{len(eng.models)} trees, {r['it_per_s']:.3f} it/s (after the "
          f"first iteration {r['it_per_s_after_first']:.3f}) on {smi}; "
          f"holdout multi_logloss {ev['multi_logloss']:.6f} (class-share "
          f"entropy {prior_logloss:.6f}), multi_error "
          f"{ev['multi_error']:.6f}; kernel A launches per iteration "
          f"{r['hist_per_iter']} (by mode {r['modes']})", flush=True)
    r["trace"] = trace_rounds(bst, TRACE_ROUNDS)
    trace_line("multiclass", r["trace"])
    # one more iteration, its K class trees' kernel-A calls recorded and
    # each held against the plain version at this shape (F = 54)
    rec = HistRecorder(modes.serial, th)
    rec.tag = "multiclass"
    bst.update()
    rec.tag = None
    rec.close()
    rng, exact = np.random.default_rng(6), {}
    for i, call in enumerate(rec.calls):
        hold_call(th, call, f"multiclass call {i}", rng, exact)
    shapes = sorted({(*c["args"][0].shape, c["args"][1].shape[0],
                      c["args"][3].shape[0]) for c in rec.calls})
    r["held_against_plain"] = dict(calls=len(rec.calls), shapes=shapes)
    print(f"objectives: multiclass: {len(rec.calls)} kernel-A calls of one "
          f"iteration (shapes F, n, C, lanes: {shapes}) held against the "
          f"plain version: int mode and exact-sum f32 mode bit-equal",
          flush=True)
    if len(rec.calls) < 2 * K or any(f != Xt.shape[1]
                                     for f, *_ in shapes):
        raise AssertionError(f"multiclass recorded calls {shapes}")
    del rec
    if r["trees"] != K * MC_ROUNDS or pred.shape != (len(Xv), K) \
            or not np.allclose(pred.sum(1), 1.0, atol=1e-5):
        raise AssertionError(f"multiclass: {r['trees']} trees, "
                             f"predictions {pred.shape}")
    if not (ev["multi_logloss"] < prior_logloss
            and ev["multi_error"] < 1.0 - max(shares)):
        raise AssertionError(f"multiclass holdout {ev}")
    if r["modes"]["f32"] or min(r["hist_per_iter"]) < 2 * K:
        raise AssertionError(f"multiclass kernel A calls {r}")
    return r


def quantile_run(lgt, th, tp, modes, smi):
    """Quantile (alpha 0.9) on 1M Higgs-shaped rows: f32 gradients (kernel
    A in f32 mode) and the host leaf renewal, timed."""
    X, y = synth_higgs(N_QUANTILE + N_HOLDOUT, N_FEAT, seed=2,
                       regression=True)
    ds = lgt.Dataset(X[:N_QUANTILE], label=y[:N_QUANTILE])
    Xv, yv = X[N_QUANTILE:], y[N_QUANTILE:]
    alpha = 0.9
    bst = lgt.Booster(params=dict(FULL_PARAMS, objective="quantile",
                                  alpha=alpha, metric="quantile",
                                  tpu_hist_partition="false"), train_set=ds)
    bst.add_valid(ds.create_valid(Xv, label=yv), "holdout")
    eng = bst.engine
    if eng.grow_cfg.int_hist or not eng.objective.renews:
        raise AssertionError("quantile: expected f32 gradients and renewal")
    renew_s = []
    renew = eng._renew

    def timed_renew(grown):
        torch.cuda.synchronize()
        t = time.perf_counter()
        renew(grown)
        torch.cuda.synchronize()
        renew_s.append(time.perf_counter() - t)
    eng._renew = timed_renew
    c0 = dict(modes.calls)
    r = timed_rounds(bst, QUANTILE_ROUNDS, th, tp)
    r["modes"] = {k: modes.calls[k] - c0[k] for k in c0}
    [(_, _, loss, _)] = bst.eval_valid()
    q = np.quantile(y[:N_QUANTILE], alpha)
    d = yv - q
    const_loss = float(np.mean(np.where(d >= 0, alpha * d, (alpha - 1) * d)))
    r.update(quantile_loss=loss, constant_loss=const_loss,
             renew_s_per_iter=list(renew_s))
    print(f"objectives: quantile alpha={alpha} n={N_QUANTILE}: "
          f"{QUANTILE_ROUNDS} rounds, {r['it_per_s']:.3f} it/s on {smi}; "
          f"host leaf renewal seconds per iteration "
          f"{[round(s, 4) for s in renew_s]}; holdout quantile loss "
          f"{loss:.6f} (the train label's {alpha} quantile as a constant: "
          f"{const_loss:.6f}); kernel A launches per iteration "
          f"{r['hist_per_iter']} (by mode {r['modes']})", flush=True)
    r["trace"] = trace_rounds(bst, TRACE_ROUNDS)
    r["trace"]["renew_ms_per_iter"] = 1e3 * sum(
        renew_s[QUANTILE_ROUNDS:]) / TRACE_ROUNDS
    trace_line("quantile", r["trace"])
    print(f"objectives: quantile traced: host leaf renewal "
          f"{r['trace']['renew_ms_per_iter']:.2f} ms per iteration",
          flush=True)
    renew_s = renew_s[:QUANTILE_ROUNDS]
    if not loss < const_loss or len(renew_s) != QUANTILE_ROUNDS:
        raise AssertionError(f"quantile: holdout loss {loss}, constant "
                             f"{const_loss}, renewals {len(renew_s)}")
    if r["modes"]["int"] or min(r["hist_per_iter"]) < 2:
        raise AssertionError(f"quantile kernel A calls {r}")
    return r


def parity_data(params, seed=0):
    """20k + 2k rows x 28 features with a label that suits the objective."""
    rng = np.random.default_rng(seed)
    n = N_PARITY + N_PARITY_HOLDOUT
    X = rng.normal(size=(n, N_FEAT))
    lin = X @ rng.normal(size=N_FEAT) * 0.3 + 0.8 * X[:, 0] * X[:, 1]
    obj = params["objective"]
    if obj in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(0.15 * lin)).astype(np.float64)
    elif obj == "gamma":
        y = rng.gamma(4.0, np.exp(0.15 * lin) / 4.0)
    elif obj.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-(lin + rng.normal(size=n))))
    elif obj == "binary":
        y = (lin + rng.normal(size=n) > 0).astype(np.float64)
    elif obj.startswith("multiclass"):
        K = params["num_class"]
        y = np.argmax(X[:, :K] + rng.normal(scale=0.7, size=(n, K)),
                      axis=1).astype(np.float64)
    else:
        y = 2.0 * lin + rng.normal(size=n)
    return X[:N_PARITY], y[:N_PARITY], X[N_PARITY:]


def parity_run(lgt, th, smi):
    """Every ported objective, 5 rounds on 20k rows, on the card and on
    the CPU (the kernels' plain versions): split lines identical,
    predictions within PARITY_PRED_TOL."""
    out = {}
    th.multi_leaf_histogram.launches = 0
    for name, obj in PARITY_OBJECTIVES.items():
        X, y, Xv = parity_data(obj)
        res = {}
        for dev in ("cuda", "cpu"):
            t = time.perf_counter()
            bst = lgt.train(dict(PARITY_PARAMS, device_type=dev, **obj),
                            lgt.Dataset(X, label=y),
                            num_boost_round=PARITY_ROUNDS)
            res[dev] = (split_lines(bst.model_to_string()),
                        bst.predict(Xv), time.perf_counter() - t)
        lines_equal = res["cuda"][0] == res["cpu"][0]
        diff = float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])
                            / np.maximum(1.0, np.abs(res["cpu"][1]))))
        out[name] = dict(split_lines_equal=lines_equal, max_rel_diff=diff,
                         seconds={d: r[2] for d, r in res.items()})
        print(f"objectives: card against CPU, {name}: split lines "
              f"{'identical' if lines_equal else 'DIFFER'}, predictions "
              f"max |diff| / max(1, |CPU|) {diff:.3g}", flush=True)
        if not lines_equal or not diff <= PARITY_PRED_TOL:
            raise AssertionError(f"card against CPU, {name}: split lines "
                                 f"equal {lines_equal}, max diff {diff}")
    out["histogram_launches"] = th.multi_leaf_histogram.launches
    if out["histogram_launches"] <= 0:
        raise AssertionError("card against CPU: kernel A never launched")
    return out


def objectives_phase(lgt, th, tp, serial, smi):
    """The regression, multiclass and quantile paths at full width, then
    every ported objective on the card against the CPU."""
    t0 = time.time()
    modes = ModeCounter(serial, th)
    try:
        res = {"regression": regression_run(lgt, th, tp, modes, smi),
               "multiclass": multiclass_run(lgt, th, tp, modes, smi),
               "quantile": quantile_run(lgt, th, tp, modes, smi),
               "card_vs_cpu": parity_run(lgt, th, smi)}
    finally:
        modes.close()
    res["seconds"] = time.time() - t0
    print(f"objectives phase: {res['seconds']:.1f} s", flush=True)
    return res


def synth_guard(n, seed=7, nan_cats=False, small_cat=False):
    """bench.py's categorical guard (the port's copy of
    ``bench.py::synth_guard``): 10 numeric features (pairwise
    interactions dominate), one 12-way and one 40-way categorical with
    target-dependent effects, 10% NaNs in half the numeric columns
    (informative missingness). ``small_cat`` adds a 3-way categorical
    column (the one-hot mode) and ``nan_cats`` 10% NaN in the categorical
    columns, for the card-against-CPU runs."""
    rng = np.random.default_rng(seed)
    Xn = rng.normal(size=(n, 10)).astype(np.float64)
    c1 = rng.integers(0, 12, size=n)
    c2 = rng.integers(0, 40, size=n)
    eff1 = rng.normal(size=12)[c1] * 1.2
    eff2 = rng.normal(size=40)[c2] * 0.8
    logit = (1.0 * Xn[:, 0] * Xn[:, 1] + 0.9 * Xn[:, 2] * Xn[:, 3]
             - 0.7 * Xn[:, 4] * np.abs(Xn[:, 5]) + eff1 + eff2)
    for j in range(5):
        miss = rng.uniform(size=n) < 0.10
        logit = logit + np.where(miss, 0.6, 0.0)
        Xn[miss, j] = np.nan
    cols = [Xn, c1.astype(np.float64), c2.astype(np.float64)]
    if small_cat:
        c3 = rng.integers(0, 3, size=n)
        logit = logit + np.array([0.5, -0.6, 0.2])[c3]
        cols.append(c3.astype(np.float64))
    y = (logit + rng.normal(scale=1.0, size=n) > 0).astype(np.float64)
    X = np.column_stack(cols)
    if nan_cats:
        for j in range(10, X.shape[1]):
            X[rng.uniform(size=n) < 0.10, j] = np.nan
    return X, y, logit


def synth_criteo(n, seed=2):
    """The Criteo CTR shape (the port's copy of the data of
    ``benchmarks/suite.py::bench_criteo``): 13 lognormal dense columns,
    26 categorical columns of 8 to 256 categories, 20 groups of 8 mutually
    exclusive 0/1 indicators; 199 features, a binary label."""
    rng = np.random.default_rng(seed)
    dense = rng.lognormal(size=(n, 13)).astype(np.float32)
    cats = np.stack([rng.integers(0, c, size=n) for c in
                     ([8, 16, 32, 64, 128, 256] * 5)[:26]], axis=1)
    groups = []
    for _ in range(20):
        sel = rng.integers(0, 9, size=n)          # 8 = absent
        groups.append((sel[:, None] == np.arange(8)[None, :])
                      .astype(np.float32))
    sparse = np.concatenate(groups, axis=1)
    X = np.concatenate([dense, cats.astype(np.float32), sparse], axis=1)
    logit = (0.4 * np.log1p(dense[:, 0]) + 0.3 * (cats[:, 0] % 3 == 0)
             + sparse[:, 0] - 0.8)
    y = (logit + rng.normal(scale=1.0, size=n) > 0).astype(np.float64)
    return X.astype(np.float64), y


def auc_of(pred, label):
    """AUC by the port's own metric."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metric import AUCMetric
    return AUCMetric(Config({})).eval(pred, label, None)[0][1]


def categorical_nodes(models):
    return sum(int(t.is_categorical.sum()) for t in models
               if t.is_categorical is not None)


class CallRecorder:
    """Takes the place of ``module.name`` (a kernel wrapper the training
    loop calls), passes every call on to it, so its launch count is
    unchanged, and while ``on`` keeps a copy of the call's arguments."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.prev = getattr(module, name)
        self.on, self.calls = False, []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        if self.on:
            self.calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args))
        return self.prev(*args, **kw)

    def close(self):
        setattr(self.module, self.name, self.prev)


def guard_run(lgt, th, smi):
    """bench.py's categorical guard at its own size and settings: 200k
    training rows, 50k holdout, 63 leaves, 50 rounds, with the two
    categorical columns and with the same columns treated as numeric."""
    X, y, _ = synth_guard(N_GUARD)
    Xt, yt = X[:N_GUARD_TRAIN], y[:N_GUARD_TRAIN]
    Xv, yv = X[N_GUARD_TRAIN:], y[N_GUARD_TRAIN:]
    out = {}
    for label, cats in (("categorical", GUARD_CATS), ("numeric", [])):
        ds = lgt.Dataset(Xt, label=yt, categorical_feature=cats)
        bst = lgt.Booster(params=dict(GUARD_PARAMS), train_set=ds)
        bst.add_valid(ds.create_valid(Xv, label=yv), "holdout")
        eng = bst.engine
        if eng.has_categorical != bool(cats):
            raise AssertionError(f"guard {label}: has_categorical "
                                 f"{eng.has_categorical}")
        th.multi_leaf_histogram.launches = 0
        secs = []
        for _ in range(GUARD_ROUNDS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        [(_, _, auc, _)] = bst.eval_valid()
        pred = bst.predict(Xv)
        out[label] = dict(
            auc=auc, it_per_s_after_first=(len(secs) - 1) / sum(secs[1:]),
            first_iter_s=secs[0], cat_nodes=categorical_nodes(eng.models),
            int_hist=eng.grow_cfg.int_hist,
            launches={"histogram": th.multi_leaf_histogram.launches})
        print(f"categorical: guard (bench.py synth_guard, {N_GUARD_TRAIN} "
              f"rows, 63 leaves) {label}: {GUARD_ROUNDS} rounds, holdout "
              f"AUC {auc:.6f}, {out[label]['it_per_s_after_first']:.3f} it/s "
              f"after the first iteration (first {secs[0]:.3f} s) on {smi}; "
              f"categorical splits {out[label]['cat_nodes']}, kernel A "
              f"launches {th.multi_leaf_histogram.launches} "
              f"({'int' if eng.grow_cfg.int_hist else 'f32'} mode)",
              flush=True)
        if not (np.isfinite(pred).all() and pred.shape == (len(Xv),)):
            raise AssertionError(f"guard {label}: predictions")
    cat, num = out["categorical"], out["numeric"]
    print(f"categorical: guard holdout AUC {cat['auc']:.6f} with the "
          f"categorical columns, {num['auc']:.6f} with them numeric "
          f"(bench.py's floor 0.85)", flush=True)
    if not (cat["auc"] > 0.85 and cat["cat_nodes"] > 0
            and num["cat_nodes"] == 0 and cat["launches"]["histogram"] > 0):
        raise AssertionError(f"guard: {out}")
    return out


def hold_moves(tc, tp, compactions, moves, label="criteo"):
    """The recorded GOSS compactions and partition moves against their
    plain versions, bit for bit."""
    for i, (bins, vals, keep, out_cols) in enumerate(compactions):
        got = tc.compact_by_mask(bins, vals, keep, out_cols)
        ref = tc.compact_by_mask_plain(bins, vals, keep, out_cols)
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{label} compaction {i} differs from "
                                 "the plain version")
    for i, (bins, vals, old, new) in enumerate(moves):
        (kb, kv, kl), knf, kcum = tp.partition_move(bins, vals, old, new)
        (pb, pv, pl), pnf, pcum = tp.partition_move_plain(bins, vals, old,
                                                          new)
        torch.cuda.synchronize()
        if not (same_bits(kb, pb) and same_bits(kv, pv)
                and same_bits(kl, pl) and same_bits(kcum, pcum)
                and int(knf) == int(pnf)):
            raise AssertionError(f"{label} partition move {i} differs "
                                 "from the plain version")
    return dict(
        compactions=[dict(shape=list(c[0].shape), values=c[1].shape[0],
                          kept=int(c[2].sum()), out_cols=c[3])
                     for c in compactions],
        moves=[dict(shape=list(m[0].shape), moved=int((m[2] != m[3]).sum()))
               for m in moves])


def criteo_run(lgt, th, tc, tp, serial, gbdt, smi):
    """The Criteo shape on three paths, CRITEO_ROUNDS rounds each (the
    GOSS path 1 / learning rate more: GOSS starts there): it/s, AUC on the
    first 100k rows, launches, categorical splits and a trace; then one
    more iteration of each whose kernel-A calls (masked), compaction
    (GOSS) or partition moves (partition) are held against the plain
    versions at F = 199. The partition's text must equal the masked
    run's."""
    t0 = time.time()
    X, y = synth_criteo(N_CRITEO)
    ds = lgt.Dataset(X, label=y, categorical_feature=CRITEO_CATS)
    ds.construct()
    Xa, ya = X[:CRITEO_AUC_ROWS], y[:CRITEO_AUC_ROWS]
    del X
    setup_s = time.time() - t0
    print(f"categorical: Criteo shape {N_CRITEO} x 199 (26 categorical): "
          f"data and binning {setup_s:.1f} s", flush=True)
    runs, texts = {}, {}
    rec = HistRecorder(serial, th)
    crec = CallRecorder(gbdt, "compact_by_mask")
    prec = CallRecorder(serial, "partition_move")
    try:
        for path, extra in CRITEO_PATHS.items():
            bst = lgt.Booster(params=dict(CRITEO_PARAMS, **extra),
                              train_set=ds)
            eng = bst.engine
            if not (eng.has_categorical and eng.grow_cfg.int_hist
                    and eng.num_features == 199
                    and eng.hist_partition == (path == "partition")
                    and eng.use_goss_compact == (path == "goss")):
                raise AssertionError(f"criteo {path}: {eng.grow_cfg}")
            warm = (int(1.0 / CRITEO_PARAMS["learning_rate"])
                    if path == "goss" else 0)
            rounds = CRITEO_ROUNDS + warm
            th.multi_leaf_histogram.launches = 0
            tc.compact_by_mask.launches = 0
            tp.partition_move.launches = 0
            secs = []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t = time.perf_counter()
                bst.update()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            launches = {"histogram": th.multi_leaf_histogram.launches,
                        "compact": tc.compact_by_mask.launches,
                        "partition": tp.partition_move.launches}
            # it/s after the first iteration; under GOSS, of the GOSS
            # iterations (after the first of them)
            timed = secs[warm + 1:]
            r = dict(rounds=rounds, it_per_s_after_first=len(timed)
                     / sum(timed), first_iter_s=secs[0],
                     iter_s=[round(s, 4) for s in secs],
                     auc_first_100k=auc_of(bst.predict(Xa), ya),
                     cat_nodes=categorical_nodes(eng.models),
                     nodes=sum(t.num_nodes for t in eng.models),
                     launches=launches,
                     hist_rows_scanned=eng.hist_rows_scanned)
            texts[path] = bst.model_to_string()
            print(f"categorical: Criteo {path}: {rounds} rounds, "
                  f"{r['it_per_s_after_first']:.3f} it/s "
                  + ("(GOSS iterations after the first) " if warm
                     else "(after the first iteration) ")
                  + f"on {smi}; seconds per iteration {r['iter_s']}; AUC "
                  f"on the first {CRITEO_AUC_ROWS} rows "
                  f"{r['auc_first_100k']:.6f}; categorical splits "
                  f"{r['cat_nodes']} of {r['nodes']}; launches {launches}",
                  flush=True)
            tr = r["trace"] = trace_rounds(bst, TRACE_ROUNDS)
            print(f"categorical: Criteo {path} traced ({TRACE_ROUNDS} more "
                  f"iterations): {tr['wall_ms_per_iter']:.2f} ms wall, device"
                  f" busy {tr['busy_ms_per_iter']} ms, idle share "
                  f"{tr['idle_share']}, device ms per iteration of the move "
                  f"and compaction kernels {tr['step_ms_per_iter']}, "
                  f"device-to-host copies per iteration "
                  f"{tr['dtoh_per_iter']}; top device time (ms per "
                  f"iteration): {tr['top_kernels']}", flush=True)
            # one more iteration with this path's kernel calls recorded
            rec.tag = "criteo_masked" if path == "masked" else None
            crec.on, prec.on = path == "goss", path == "partition"
            bst.update()
            rec.tag, crec.on, prec.on = None, False, False
            runs[path] = r
            if not (launches["histogram"] > 0 and r["cat_nodes"] > 0
                    and math.isfinite(r["it_per_s_after_first"])
                    and r["auc_first_100k"] > 0.6):
                raise AssertionError(f"criteo {path}: {r}")
            if (launches["compact"] > 0) != (path == "goss") or \
                    (launches["partition"] > 0) != (path == "partition"):
                raise AssertionError(f"criteo {path}: launches {launches}")
            del bst, eng
    finally:
        rec.close()
        crec.close()
        prec.close()
    if texts["partition"] != texts["masked"]:
        raise AssertionError("criteo: model text differs with the "
                             "partition on")
    rng, exact = np.random.default_rng(9), {}
    for i, call in enumerate(rec.calls):
        hold_call(th, call, f"criteo call {i}", rng, exact)
    shapes = sorted({(*c["args"][0].shape, c["args"][1].shape[0],
                      c["args"][3].shape[0]) for c in rec.calls})
    held = dict(histogram_calls=len(rec.calls), histogram_shapes=shapes,
                **hold_moves(tc, tp, crec.calls, prec.calls))
    print(f"categorical: Criteo kernels at F = 199 held against the plain "
          f"versions: {len(rec.calls)} kernel-A calls of one masked "
          f"iteration (shapes F, n, C, lanes: {shapes}; int mode and "
          f"exact-sum f32 mode bit-equal), compactions {held['compactions']}"
          f" and partition moves {held['moves']} bit-equal", flush=True)
    if not (len(rec.calls) >= 2 and all(f == 199 for f, *_ in shapes)
            and crec.calls and prec.calls):
        raise AssertionError(f"criteo recorded calls: {held}")
    return dict(runs, held_against_plain=held, setup_s=setup_s,
                partition_text_equal=True)


class SameDraws:
    """The same uniforms on every device (numpy's generator seeded with
    the iteration and the stream, moved to ``device``): each device's own
    torch generator gives other numbers, and GOSS samples by them."""

    def __init__(self, device):
        self.device = device

    def _u(self, iteration, n, stream):
        u = np.random.default_rng([iteration, stream]).random(
            n, dtype=np.float32)
        return torch.from_numpy(u).to(self.device)

    def rank_uniforms(self, iteration, Q, M, goss):
        return self._u(iteration, Q * M, 99).reshape(Q, M)

    def goss_uniform(self, iteration, n):
        return self._u(iteration, n, 0)

    def quant_uniforms(self, iteration, n, k=0):
        return (self._u(iteration, n, 1 + 2 * k) - 0.5,
                self._u(iteration, n, 2 + 2 * k) - 0.5)


def categorical_parity_run(lgt, th, tc, tp, smi):
    """A 20k-row guard-shaped set (a 3-way column for the one-hot mode,
    10% NaN in the categorical columns), 5 rounds on the masked, GOSS and
    partition paths, binary on quantized and exact gradients and 3-class
    multiclass, on the card and on the CPU from the same draws
    (``SameDraws``): split lines identical,
    predictions within PARITY_PRED_TOL, categorical splits present. On
    exact gradients kernel A adds float32 values in another order than
    the plain version, and the sorted scan's two equal-gain forms of one
    left set (a prefix and the complement's prefix, children swapped)
    follow those last bits: there, if the lines differ, every tree must
    put the same training rows in each leaf."""
    X, y, logit = synth_guard(N_PARITY + N_PARITY_HOLDOUT, seed=3,
                              nan_cats=True, small_cat=True)
    labels = {"binary": y, "multiclass": np.digitize(
        logit, np.quantile(logit, [1 / 3, 2 / 3])).astype(np.float64)}
    cats = list(range(10, X.shape[1]))
    out = {}
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    for setting, obj in CAT_PARITY_SETTINGS.items():
        yy = labels[obj["objective"]]
        for path, extra in CAT_PARITY_PATHS.items():
            res = {}
            for dev in ("cuda", "cpu"):
                bst = lgt.train(
                    dict(PARITY_PARAMS, device_type=dev, **obj, **extra),
                    lgt.Dataset(X[:N_PARITY], label=yy[:N_PARITY],
                                categorical_feature=cats),
                    num_boost_round=PARITY_ROUNDS, noise=SameDraws(dev))
                eng = bst.engine
                if eng.use_goss_compact != (path == "goss") or \
                        eng.hist_partition != (path == "partition"):
                    raise AssertionError(f"card against CPU {setting} "
                                         f"{path}: engine paths")
                res[dev] = (split_lines(bst.model_to_string()),
                            bst.predict(X[N_PARITY:]),
                            categorical_nodes(eng.models),
                            bst.predict(X[:N_PARITY], pred_leaf=True))
            equal = res["cuda"][0] == res["cpu"][0]
            same_rows = all(
                len(set(zip(a.tolist(), b.tolist())))
                == len(set(a.tolist())) == len(set(b.tolist()))
                for a, b in zip(res["cuda"][3].T, res["cpu"][3].T))
            diff = float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])
                                / np.maximum(1.0, np.abs(res["cpu"][1]))))
            out[f"{setting}_{path}"] = dict(
                split_lines_equal=equal, same_leaf_rows=same_rows,
                max_rel_diff=diff, cat_nodes=res["cpu"][2])
            print(f"categorical: card against CPU, {setting} {path}: split "
                  f"lines {'identical' if equal else 'DIFFER'}, the same "
                  f"rows in every leaf {same_rows}, categorical splits "
                  f"{res['cpu'][2]}, predictions max |diff| / max(1, |CPU|)"
                  f" {diff:.3g}", flush=True)
            exact = not obj.get("use_quantized_grad", True)
            if not ((equal or (exact and same_rows))
                    and diff <= PARITY_PRED_TOL and res["cpu"][2] > 0):
                raise AssertionError(f"categorical card against CPU, "
                                     f"{setting} {path}: {out}")
    out["launches"] = {"histogram": th.multi_leaf_histogram.launches,
                       "compact": tc.compact_by_mask.launches,
                       "partition": tp.partition_move.launches}
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"categorical card against CPU: launches "
                             f"{out['launches']}")
    return out


def categorical_phase(lgt, th, tc, tp, serial, gbdt, smi):
    """bench.py's categorical guard, the Criteo shape on three paths with
    its kernels held at F = 199, and categorical training on the card
    against the CPU."""
    t0 = time.time()
    res = {"guard": guard_run(lgt, th, smi),
           "criteo": criteo_run(lgt, th, tc, tp, serial, gbdt, smi),
           "card_vs_cpu": categorical_parity_run(lgt, th, tc, tp, smi)}
    res["seconds"] = time.time() - t0
    print(f"categorical phase: {res['seconds']:.1f} s", flush=True)
    return res


def synth_mslr(counts, seed=0):
    """The MSLR-Web30K shape (the port's copy of the generator of
    ``benchmarks/suite.py::bench_mslr``): 136 standard-normal features,
    30% of them in a linear score, relevance 0-4 from the score plus
    noise; ``counts`` documents per query. float32 features."""
    rng = np.random.default_rng(seed)
    n = int(np.sum(counts))
    X = rng.normal(size=(n, MSLR_F)).astype(np.float32)
    w = rng.normal(size=MSLR_F) * (rng.random(MSLR_F) < 0.3)
    rel = np.clip((X @ w) * 0.35 + rng.normal(scale=0.8, size=n) + 1.2,
                  0, 4).astype(int).astype(float)
    return X, rel


def mslr_lengths(seed=1):
    """MSLR-Web30K Fold 1's query-length spread: 18,919 lengths from a
    lognormal of mean about 120, clipped to 1..1,251, the longest 1,251."""
    rng = np.random.default_rng(seed)
    counts = np.clip(np.round(rng.lognormal(np.log(120.0) - 0.245, 0.7,
                                            size=N_LENGTHS_QUERIES)),
                     1, LENGTHS_MAX).astype(np.int64)
    counts[int(np.argmax(counts))] = LENGTHS_MAX
    return counts


def pair_share(counts, T):
    """The share of the padded ``[Q, T, M]`` pair tensor that pairs two
    real documents (i < min(T, n_q), i < j < n_q)."""
    c = np.asarray(counts, np.int64)
    t = np.minimum(T, c)
    real = np.sum(t * (c - 1) - t * (t - 1) // 2)
    return float(real) / (len(c) * min(T, int(c.max())) * int(c.max()))


def gradient_ms(eng, reps=3):
    """The objective's gradients at the engine's scores: device ms a call
    (CUDA events) and the call's peak device memory above what was
    allocated before it (bytes)."""
    obj, d = eng.objective, eng.data
    s = eng.score[:, 0]
    kw = {}
    if obj.needs_rng:
        kw["gammas"] = torch.rand(obj.query_shape, device=s.device)
    elif eng._pos_state is not None:
        kw["pos_state"] = eng._pos_state.clone()
    obj.get_gradients(s, d.label, d.weight, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        obj.get_gradients(s, d.label, d.weight, **kw)
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps,
            torch.cuda.max_memory_allocated() - base)


def ndcg_line(rows):
    return ", ".join(f"{m} {v:.6f}" for _, m, v, _ in rows)


def rank_run(lgt, th, tc, tp, bst, rounds, warm, label, smi):
    """``rounds`` iterations of a ranking booster from launch counts of 0:
    it/s after the first (of the GOSS iterations under GOSS), holdout
    ndcg, launches, the gradient's device ms and a trace."""
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    secs = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    launches = {"histogram": th.multi_leaf_histogram.launches,
                "compact": tc.compact_by_mask.launches,
                "partition": tp.partition_move.launches}
    eng = bst.engine
    timed = secs[warm + 1:]
    rows = bst.eval_valid()
    g_ms, g_mem = gradient_ms(eng)
    r = dict(rounds=rounds, it_per_s_after_first=len(timed) / sum(timed),
             first_iter_s=secs[0], iter_s=[round(x, 4) for x in secs],
             holdout={m: v for _, m, v, _ in rows}, launches=launches,
             int_hist=eng.grow_cfg.int_hist, gradient_ms=g_ms,
             gradient_peak_bytes=g_mem,
             hist_rows_scanned=eng.hist_rows_scanned)
    print(f"ranking: {label}: {rounds} rounds, "
          f"{r['it_per_s_after_first']:.3f} it/s "
          + ("(GOSS iterations after the first) " if warm
             else "(after the first iteration) ")
          + f"on {smi}; seconds per iteration {r['iter_s']}; holdout "
          f"{ndcg_line(rows)}; launches {launches} (kernel A "
          f"{'int' if eng.grow_cfg.int_hist else 'f32'} mode); gradient "
          f"{g_ms:.3f} device ms a call, peak {g_mem / 2**20:.1f} MiB",
          flush=True)
    tr = r["trace"] = trace_rounds(bst, TRACE_ROUNDS)
    print(f"ranking: {label} traced ({TRACE_ROUNDS} more iterations): "
          f"{tr['wall_ms_per_iter']:.2f} ms wall, device busy "
          f"{tr['busy_ms_per_iter']} ms, idle share {tr['idle_share']}, "
          f"device ms per iteration of the move and compaction kernels "
          f"{tr['step_ms_per_iter']}, device-to-host copies per iteration "
          f"{tr['dtoh_per_iter']}; top device time (ms per iteration): "
          f"{tr['top_kernels']}", flush=True)
    if not (launches["histogram"] > 0 and math.isfinite(
            r["it_per_s_after_first"]) and all(
            0.0 < v <= 1.0 for v in r["holdout"].values())):
        raise AssertionError(f"ranking {label}: {r}")
    return r


def mslr_run(lgt, th, tc, tp, serial, gbdt, smi):
    """The suite's MSLR shape on four paths (MSLR_ROUNDS rounds, GOSS 1 /
    learning rate more first), then rank_xendcg and lambdarank_unbiased on
    the masked path; one more quantized iteration's kernel-A calls, a
    GOSS compaction and the partition moves at F = 136 held against the
    plain versions. The partition's text must equal the quantized masked
    run's."""
    t0 = time.time()
    counts = np.full(N_MSLR_QUERIES, MSLR_DOCS)
    X, rel = synth_mslr(counts)
    n = N_MSLR_TRAIN_QUERIES * MSLR_DOCS
    ds = lgt.Dataset(X[:n], label=rel[:n],
                     group=counts[:N_MSLR_TRAIN_QUERIES])
    ds.construct()
    valid = ds.create_valid(X[n:], label=rel[n:],
                            group=counts[N_MSLR_TRAIN_QUERIES:]).construct()
    del X
    setup_s = time.time() - t0
    print(f"ranking: MSLR shape {N_MSLR_TRAIN_QUERIES} queries x "
          f"{MSLR_DOCS} documents ({n} rows) x {MSLR_F}, holdout "
          f"{N_MSLR_QUERIES - N_MSLR_TRAIN_QUERIES} queries: data and "
          f"binning {setup_s:.1f} s", flush=True)
    runs, texts = {}, {}
    rec = HistRecorder(serial, th)
    crec = CallRecorder(gbdt, "compact_by_mask")
    prec = CallRecorder(serial, "partition_move")
    try:
        for path, extra in list(MSLR_PATHS.items()) + [
                (name, dict(MSLR_PATHS["masked"], **p))
                for name, p in MSLR_SIDE.items()]:
            bst = lgt.Booster(params=dict(MSLR_PARAMS, **extra),
                              train_set=ds)
            bst.add_valid(valid, "holdout")
            eng = bst.engine
            quant = bool(extra.get("use_quantized_grad"))
            if not (eng.objective.is_ranking and eng.num_features == MSLR_F
                    and eng.grow_cfg.int_hist == quant
                    and eng.hist_partition == (path == "partition")
                    and eng.use_goss_compact == (path == "goss")):
                raise AssertionError(f"mslr {path}: {eng.grow_cfg}")
            side = path in MSLR_SIDE
            warm = (int(1.0 / MSLR_PARAMS["learning_rate"])
                    if path == "goss" else 0)
            rounds = (MSLR_SIDE_ROUNDS if side else MSLR_ROUNDS) + warm
            r = rank_run(lgt, th, tc, tp, bst, rounds, warm,
                         f"MSLR {path}", smi)
            texts[path] = bst.model_to_string()
            # one more iteration with this path's kernel calls recorded
            rec.tag = "mslr_quantized" if path == "quantized" else None
            crec.on, prec.on = path == "goss", path == "partition"
            bst.update()
            rec.tag, crec.on, prec.on = None, False, False
            runs[path] = r
            launches = r["launches"]
            if (launches["compact"] > 0) != (path == "goss") or \
                    (launches["partition"] > 0) != (path == "partition"):
                raise AssertionError(f"mslr {path}: launches {launches}")
            del bst, eng
    finally:
        rec.close()
        crec.close()
        prec.close()
    if texts["partition"] != texts["quantized"]:
        raise AssertionError("mslr: model text differs with the partition "
                             "on")
    # each call held bit-equal and timed beside the plain version,
    # index_add_ and the bound
    replay = replay_phase(torch.device("cuda"), th, rec.calls, {})
    shapes = sorted({(*c["args"][0].shape, c["args"][1].shape[0],
                      c["args"][3].shape[0]) for c in rec.calls})
    held = dict(histogram_calls=len(rec.calls), histogram_shapes=shapes,
                replay=[{k: r[k] for k in REPLAY_KEYS} for r in replay],
                **hold_moves(tc, tp, crec.calls, prec.calls, "mslr"))
    mean = {m: sum(r[f"{m}_kernel_ms"] for r in replay) / len(replay)
            for m in ("int", "f32")}
    print(f"ranking: MSLR kernels at F = {MSLR_F} held against the plain "
          f"versions: {len(rec.calls)} kernel-A calls of one quantized "
          f"iteration (shapes F, n, C, lanes: {shapes}; int mode and "
          f"exact-sum f32 mode bit-equal; mean {mean['int']:.4f} ms int, "
          f"{mean['f32']:.4f} ms f32 a call), compactions "
          f"{held['compactions']} and partition moves {held['moves']} "
          f"bit-equal", flush=True)
    if not (len(rec.calls) >= 2 and all(f == MSLR_F for f, *_ in shapes)
            and crec.calls and prec.calls):
        raise AssertionError(f"mslr recorded calls: {held}")
    return dict(runs, held_against_plain=held, setup_s=setup_s,
                partition_text_equal=True)


def lengths_run(lgt, th, tc, tp, smi):
    """MSLR-Web30K Fold 1's query-length spread at 136 features: masked
    lambdarank, LENGTHS_ROUNDS rounds; it/s, the gradient's device ms and
    peak memory with the port's chunking, and the share of the padded
    pair work that falls on real documents."""
    t0 = time.time()
    counts = mslr_lengths()
    X, rel = synth_mslr(counts, seed=3)
    gen_s = time.time() - t0
    t0 = time.time()
    ds = lgt.Dataset(X, label=rel, group=counts).construct()
    bin_s = time.time() - t0
    del X
    bst = lgt.Booster(params=dict(MSLR_PARAMS, **MSLR_PATHS["masked"]),
                      train_set=ds)
    eng = bst.engine
    Q, M = eng.objective.query_shape
    T = min(eng.objective.truncation, M)
    share = pair_share(counts, T)
    print(f"ranking: MSLR lengths: {len(counts)} queries, {ds.num_data} "
          f"rows x {MSLR_F} (mean {counts.mean():.1f}, longest {M} "
          f"documents): data {gen_s:.1f} s, host binning {bin_s:.1f} s; "
          f"real pairs are {share:.4f} of the padded [Q, T, M] pair "
          f"tensor ({Q} x {T} x {M})", flush=True)
    th.multi_leaf_histogram.launches = 0
    secs = []
    for _ in range(LENGTHS_ROUNDS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    g_ms, g_mem = gradient_ms(eng)
    [(_, _, ndcg, _)] = [r for r in bst.eval_train() if r[1] == "ndcg@1"]
    r = dict(queries=len(counts), rows=ds.num_data, longest=int(M),
             data_s=gen_s, binning_s=bin_s, pair_share=share,
             chunk_queries=eng.objective.chunk_queries(T, M),
             it_per_s_after_first=(len(secs) - 1) / sum(secs[1:]),
             iter_s=[round(x, 4) for x in secs], gradient_ms=g_ms,
             gradient_peak_bytes=g_mem, train_ndcg1=ndcg,
             launches={"histogram": th.multi_leaf_histogram.launches})
    print(f"ranking: MSLR lengths lambdarank masked: {LENGTHS_ROUNDS} rounds,"
          f" {r['it_per_s_after_first']:.3f} it/s after the first on {smi};"
          f" seconds per iteration {r['iter_s']}; gradient {g_ms:.3f} device"
          f" ms a call in chunks of {r['chunk_queries']} queries, peak "
          f"{g_mem / 2**30:.3f} GiB above the resident data; training "
          f"ndcg@1 {ndcg:.6f}; kernel A launches "
          f"{r['launches']['histogram']}", flush=True)
    if not (r["launches"]["histogram"] > 0 and 0 < ndcg <= 1
            and math.isfinite(r["it_per_s_after_first"])):
        raise AssertionError(f"mslr lengths: {r}")
    return r


def rank_parity_data(seed=5):
    """A 20k-row MSLR-shaped set: uneven queries (1 to 200 documents, one
    of one document, every 25th of relevance all zero), positions 0-9."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 201, size=N_RANK_PARITY // 50)
    counts = counts[np.cumsum(counts) <= N_RANK_PARITY]
    counts[3] = 1
    X, rel = synth_mslr(counts, seed=seed)
    qb = np.concatenate([[0], np.cumsum(counts)])
    for q in range(0, len(counts), 25):
        rel[qb[q]:qb[q + 1]] = 0
    pos = np.concatenate([np.arange(c) for c in counts]) % 10
    return X, rel, counts, pos


def rank_parity_run(lgt, th, tc, tp, smi):
    """Lambdarank (quantized without stochastic rounding, and exact),
    rank_xendcg and lambdarank with a position field, 5 rounds on the
    masked, GOSS and partition paths, on the card and on the CPU from the
    same draws: quantized runs give identical split lines; exact ones the
    same, or the first parting tree is printed and the predictions before
    it held within 1e-4; predictions within PARITY_PRED_TOL otherwise."""
    X, rel, counts, pos = rank_parity_data()
    out = {}
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    for setting, obj in RANK_PARITY_SETTINGS.items():
        for path, extra in CAT_PARITY_PATHS.items():
            res = {}
            for dev in ("cuda", "cpu"):
                ds = lgt.Dataset(X, label=rel, group=counts)
                if setting == "lambdarank_position":
                    ds.set_position(pos)
                bst = lgt.train(
                    dict(RANK_PARITY_PARAMS, device_type=dev, **obj,
                         **extra), ds, num_boost_round=PARITY_ROUNDS,
                    noise=SameDraws(dev))
                eng = bst.engine
                if eng.hist_partition != (path == "partition") or \
                        eng.use_goss_compact != (
                            path == "goss"
                            and setting != "lambdarank_position"):
                    raise AssertionError(f"ranking card against CPU "
                                         f"{setting} {path}: engine paths")
                res[dev] = (bst.model_to_string(), bst)
            lines = [[split_lines(t) for t in
                      res[d][0].split("\nTree=")[1:]] for d in ("cuda",
                                                                "cpu")]
            part = next((i for i, (a, b) in enumerate(zip(*lines))
                         if a != b), None)
            upto = PARITY_ROUNDS if part is None else part
            pc = res["cuda"][1].predict(X, num_iteration=max(upto, 1))
            pp = res["cpu"][1].predict(X, num_iteration=max(upto, 1))
            diff = float(np.max(np.abs(pc - pp)
                                / np.maximum(1.0, np.abs(pp))))
            out[f"{setting}_{path}"] = dict(parting_tree=part,
                                            max_rel_diff=diff)
            parted = "identical" if part is None else f"part at tree {part}"
            print(f"ranking: card against CPU, {setting} {path}: split "
                  f"lines {parted}, predictions (of the trees before any "
                  f"part) max |diff| / max(1, |CPU|) {diff:.3g}", flush=True)
            exact = setting == "lambdarank_exact"
            tol = 1e-4 if part is not None else PARITY_PRED_TOL
            if not ((part is None or exact) and diff <= tol):
                raise AssertionError(f"ranking card against CPU, {setting} "
                                     f"{path}: {out}")
    out["launches"] = {"histogram": th.multi_leaf_histogram.launches,
                       "compact": tc.compact_by_mask.launches,
                       "partition": tp.partition_move.launches}
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"ranking card against CPU: launches "
                             f"{out['launches']}")
    return out


def ranking_phase(lgt, th, tc, tp, serial, gbdt, smi):
    """The suite's MSLR shape on four paths and two more objectives with
    its kernels held at F = 136, MSLR's query-length spread, and ranking
    on the card against the CPU."""
    t0 = time.time()
    res = {"mslr": mslr_run(lgt, th, tc, tp, serial, gbdt, smi),
           "lengths": lengths_run(lgt, th, tc, tp, smi),
           "card_vs_cpu": rank_parity_run(lgt, th, tc, tp, smi)}
    res["seconds"] = time.time() - t0
    print(f"ranking phase: {res['seconds']:.1f} s", flush=True)
    return res


def main(argv):
    json_out = argv[argv.index("--json-out") + 1] if "--json-out" in argv \
        else None
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.boosting.gbdt import pad_rows
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import compact as tc
    from lightgbm_tpu_torch.ops import hist_probes as hp
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import partition as tp
    from lightgbm_tpu_torch.learner import serial
    from lightgbm_tpu_torch.boosting import gbdt
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    jobs = start_extra_builds(kernels)
    pjobs = start_parent_builds(kernels)
    try:
        kernels.build()
    finally:
        extras, nibble_extras, probe_extras, extra_paths = \
            finish_extra_builds(jobs)
        parent = finish_parent_builds(pjobs)
    print(f"kernel build (nvcc, {len(kernels.KERNELS) + len(jobs)} sources "
          f"in parallel, + {len(pjobs)} under {MOVE_PARENT_DIR}): "
          f"{time.time() - t0:.2f} s", flush=True)
    for lib in [kernels.library_path("histogram")] + [
            extra_paths[x] for x in extras]:
        # the main path's instances: 4-row loads, 3 channels, int and f32
        for func, (usage, ops) in sass_summary(lib, kernels).items():
            if "hist_kernelILb" in func and "ELi4ELi3EE" in func:
                mode = "int" if "hist_kernelILb1" in func else "f32"
                print(f"sass {os.path.basename(str(lib))} {mode} mode "
                      f"(C=3): {usage}; atomics {ops}", flush=True)
    nibble_usage = None
    for lib in [kernels.library_path("hist_probes")] + [
            extra_paths[x] for x in list(nibble_extras) + list(probe_extras)]:
        # the probe shapes' instances: 3 channels (4-row loads where the
        # kernel also has a 1-row instance)
        for func, (usage, ops) in sass_summary(lib, kernels).items():
            if "probe_nibble_kernelILi3E" in func and "ILi3ELi1E" not in func:
                print(f"sass {os.path.basename(str(lib))} nibble probe "
                      f"(C=3): {usage}; atomics {ops}", flush=True)
                nibble_usage = nibble_usage or usage
            elif "probe_1d_kernel" in func and (
                    "ELi4ELi3EE" in func or "ILi3EE" in func):
                print(f"sass {os.path.basename(str(lib))} 1-D probe "
                      f"{func} (C=3): {usage}; atomics {ops}", flush=True)

    if "--only-probes" in argv:
        probe_phase(dev, hp, th, nibble_extras, nibble_usage, probe_extras)
        return 0
    if "--only-sweep" in argv:
        partition_sweep_phase(lgt, tp)
        return 0
    if "--only-objectives" in argv:
        objectives_phase(lgt, th, tp, serial, smi)
        return 0
    if "--only-categorical" in argv:
        categorical_phase(lgt, th, tc, tp, serial, gbdt, smi)
        return 0
    if "--only-ranking" in argv:
        ranking_phase(lgt, th, tc, tp, serial, gbdt, smi)
        return 0
    n_full_pad = pad_rows(N_FULL, Config({}).tpu_rows_per_block)
    hist = histogram_phase(dev, th, tp, n_full_pad)
    comp = compaction_phase(dev, tc, parent)
    part = partition_phase(dev, tp, n_full_pad, parent)
    probes = probe_phase(dev, hp, th, nibble_extras, nibble_usage,
                         probe_extras)
    rec = HistRecorder(serial, th)
    train = train_phase(lgt, th, tc, tp, rec)
    full = full_row_phase(lgt, th, tc, tp, n_full_pad, rec, extras)
    rec.close()
    replay = replay_phase(dev, th, rec.calls, extras)
    del rec
    sweep = partition_sweep_phase(lgt, tp)
    objs = objectives_phase(lgt, th, tp, serial, smi)
    cat = categorical_phase(lgt, th, tc, tp, serial, gbdt, smi)
    rank = ranking_phase(lgt, th, tc, tp, serial, gbdt, smi)

    h, c, p = hist["masked"], comp["goss"], part["half"]
    fl = {m: r["launches"] for m, r in full.items()}

    def path_launches(key):
        reg = objs["regression"]
        return {"goss_flagship": train["launches"][key],
                "full_row_masked": fl["false"][key],
                "full_row_partition": fl["true"][key],
                "regression_masked": reg["false"]["launches"].get(key, 0),
                "regression_partition": reg["true"]["launches"].get(key, 0),
                "multiclass": objs["multiclass"]["launches"].get(key, 0),
                "quantile": objs["quantile"]["launches"].get(key, 0),
                "categorical_guard":
                    cat["guard"]["categorical"]["launches"].get(key, 0),
                **{f"criteo_{p}": cat["criteo"][p]["launches"][key]
                   for p in CRITEO_PATHS},
                "categorical_card_vs_cpu":
                    cat["card_vs_cpu"]["launches"][key],
                **{f"mslr_{p}": rank["mslr"][p]["launches"][key]
                   for p in list(MSLR_PATHS) + list(MSLR_SIDE)},
                "mslr_lengths": rank["lengths"]["launches"].get(key, 0),
                "ranking_card_vs_cpu": rank["card_vs_cpu"]["launches"][key]}

    def probe_entry(name, tag, source_line):
        pr = probes[name]
        v = pr["variants"][tag]
        return dict(name=name, route="cuda",
                    source="lightgbm_tpu_torch/csrc/hist_probes.cu",
                    replaces=source_line,
                    launches=probes["launches"][name],
                    max_abs_err=v["max_abs_err"], ms=v["ms"],
                    plain_ms=pr["plain_ms"], bound_ms=pr["bound_ms"],
                    bound_by=pr["bound_by"], library_ms=pr["library_ms"],
                    max_abs_diff=v["max_abs_err"], kernel_ms=v["ms"],
                    kernel_a_f32_ms=pr["variants"]["kernel_a"]["ms"],
                    shapes={k: pr[k] for k in ("F", "n", "B", "K", "C",
                                               "matched_rows")},
                    variants=pr["variants"], **(dict(
                        earlier_ms=v["earlier_ms"], call_ms=v["call_ms"],
                        plan=v["plan"], uniform_ids={
                            k: probes["hist_probe_1d_uniform"][k]
                            for k in ("F", "n", "B", "K", "C",
                                      "matched_rows", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by",
                                      "variants")})
                        if name == "hist_probe_1d" else {}), **(dict(
                        ms_by_nb={nb: pr["variants"][f"nb{nb}"]["ms"]
                                  for nb in hp.NIBBLE_WIDTHS},
                        earlier_ms_by_nb={
                            nb: pr["variants"][f"nb{nb}"]["earlier_ms"]
                            for nb in hp.NIBBLE_WIDTHS},
                        plan_by_nb={nb: pr["variants"][f"nb{nb}"]["plan"]
                                    for nb in hp.NIBBLE_WIDTHS})
                        if name == "hist_probe_nibble" else {}))

    kernels_line = {"kernels": [
        dict(name="multi_leaf_histogram", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:80",
             launches=train["launches"]["histogram"],
             launches_by_path=path_launches("histogram"),
             max_abs_err=h["int_max_abs_err"], ms=h["int_ms"],
             plain_ms=h["int_plain_ms"], bound_ms=h["bound_ms"],
             bound_by=h["bound_by"], library_ms=h["library_ms"],
             max_abs_diff=h["int_max_abs_err"], kernel_ms=h["int_ms"],
             shapes={k: v for k, v in hist.items()},
             replay=[{k: r[k] for k in REPLAY_KEYS} for r in replay],
             replay_mslr=rank["mslr"]["held_against_plain"]["replay"]),
        dict(name="compact_by_mask", route="cuda",
             source="lightgbm_tpu_torch/csrc/compact.cu",
             core="lightgbm_tpu_torch/csrc/stable_partition.cuh",
             replaces="lightgbm_tpu/ops/compact.py:166",
             launches=train["launches"]["compact"],
             launches_by_path=path_launches("compact"),
             max_abs_err=c["max_abs_err"], ms=c["ms"],
             earlier_step_ms=c["earlier_ms"],
             plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
             bound_by=c["bound_by"], library_ms=c["library_ms"],
             max_abs_diff=c["max_abs_err"], kernel_ms=c["ms"],
             shapes={k: v for k, v in comp.items()}),
        dict(name="partition_move", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             core="lightgbm_tpu_torch/csrc/stable_partition.cuh",
             replaces="lightgbm_tpu/ops/partition.py:129",
             launches=fl["true"]["partition"],
             launches_by_path=path_launches("partition"),
             max_abs_err=p["max_abs_err"], ms=p["ms"],
             earlier_step_ms=p["earlier_ms"],
             plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
             bound_by=p["bound_by"], library_ms=p["library_ms"],
             max_abs_diff=p["max_abs_err"], kernel_ms=p["ms"],
             shapes={k: v for k, v in part.items()}),
        probe_entry("hist_probe_1d", "probe",
                    "benchmarks/kernel_probe.py:43"),
        probe_entry("hist_probe_nibble", "nb16",
                    "benchmarks/nibble_probe.py:83"),
    ], "train": dict({k: v for k, v in train.items()
                      if k not in ("trees_leaves",)}, full_row=full,
                     partition_sweep=sweep, objectives=objs,
                     categorical=cat, ranking=rank)}
    for v in (kernels_line["train"]["masked_it_per_s"],
              kernels_line["train"]["goss_it_per_s"]):
        if not math.isfinite(v):
            raise AssertionError("non-finite iteration rate")
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(dict(kernels_line, replay=replay), fh, indent=1)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
