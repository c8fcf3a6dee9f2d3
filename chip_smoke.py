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
   forced on in turns (off, on, on, off), 6 rounds a run, at 2M, 8M and
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
10. Exclusive Feature Bundling: the Criteo shape with the suite's own
   ``enable_bundle`` on the Dataset the categorical phase binned (no
   second binning; bundling happens when the booster is built): 199
   logical features must become 59 physical columns, which kernel A
   scans, on the masked path, GOSS (which stays masked under EFB: B
   must not launch) and the forced partition (B′ moves the physical
   columns), 10 rounds each (GOSS 10 more first), each traced beside the
   unbundled masked run on the same data (kernel A ms per iteration,
   resident bytes of the bins), the partition's text byte-equal to the
   masked run's, one more iteration's kernel-A calls and moves at
   F = 59 held against their plain versions; then 20k Criteo-shaped rows
   with 8 sparse continuous columns, bundled, on the card and on the CPU:
   masked, GOSS, partition, exact gradients, ``max_conflict_rate`` 0.2
   and CSR input;
11. learning to rank: the MSLR-Web30K shape of ``benchmarks/suite.py``'s
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
   on the three paths, on the card and on the CPU;
12. the Bosch configuration of ``benchmarks/suite.py``'s ``bench_bosch``
   at its own size and settings (300,000 x 200, regression, DART with
   ``max_drop`` 4 under GOSS with the compacted buffer, feature 0
   monotone increasing, 127 leaves): 14 rounds warm (GOSS from 10), 15
   timed (it/s, the iterations and trees dropped, the dropped-tree
   traversal's ms an iteration), 2 traced (idle share, kernel A's and
   B's device ms, device-to-host copies), train RMSE beside the label's
   std; one full-row and one GOSS iteration's kernel-A calls (f32 mode,
   F = 200) held against the plain version (within the f32 tolerance on
   their own values, bit for bit in int mode and on exact-sum values)
   and timed, the GOSS compaction (200 bin rows) bit-equal and timed;
   the response to feature 0 over 201 points at 5 rows must not fall;
   then seven 20k-row runs on the card and on the CPU (DART + GOSS +
   monotone, DART masked, DART with the partition forced on, the
   intermediate method at leaf batch 8, ``monotone_penalty`` 1,
   ``xgboost_dart_mode``, binary DART): the same drops, split lines
   identical, predictions within 1e-5;
13. the input layer: bench.py::main's default rows, 10,000,000 x 28
   Higgs-like (float64 holding float32 values), binned three ways in
   turns (a b c c b a): (a) the plain NumPy functions (the bound search
   and a column at a time, the route before the native binner), (b)
   ``tpu_ingest_device=false`` (the native row-major pass), (c) ``auto``
   (device ingest, which it must take): the seconds of the bound search,
   the assignment and ``construct`` of each, for (c) also its chunks, H2D
   bytes and the assignment's device ms; ``bins`` and ``bins_t``
   byte-equal across the three; the flagship's settings for 3 rounds
   from (b) and from (c): model texts equal outside the parameters block,
   kernel A launching on the adopted ``bins_t``; then a 1M x 28 matrix of
   NaN, +-0, +-inf, the float32 values at and beside every bound and two
   categorical columns (unseen and negative ids), binned against fixed
   mappers the three ways, byte-equal;
14. the split search's options at the flagship's data and settings (1M
   x 28 binned once on the device route, 127 leaves, GOSS with the
   compacted buffer from iteration 10, quantized gradients), 12 rounds
   of each of (a) ``feature_fraction_bynode`` 0.5 with ``extra_trees``,
   (b) ``path_smooth`` 50 with ``feature_contri`` 0.5 on features 0-3,
   (c) interaction constraints in two overlapping groups, (d) CEGB's
   split, coupled and lazy penalties, (e) a 3-level forced-split tree on
   features 0-2 with ``tpu_hist_partition=true``, each beside a plain
   flagship booster updated in turns with it: it/s of both, holdout
   AUC, kernel A / B / B′ launches, one traced GOSS iteration's
   device-to-host copies (the plain flagship's beside (a)'s); (d)'s
   coupled penalty must be 0 for exactly the features in use and it
   must use fewer distinct features than the plain flagship; every tree
   of (e) must start with the forced lines; one more GOSS iteration of
   (a) and (e): kernel-A calls, the compaction and (e)'s partition moves
   held bit for bit against the plain versions; then 15 runs of 20k
   rows on the card and on the CPU from the same draws (bynode's and
   extra_trees' included): the search options and the limits
   (interaction, CEGB) on the masked, GOSS, partition paths and exact
   gradients, the forced splits likewise, bynode and extra_trees on the
   categorical guard's columns, 3-class multiclass with lazy CEGB, DART
   with bynode and interaction constraints: split lines identical,
   predictions within 1e-5.

Dense phases of 65,536 rows or more bin on the device (``auto``); each
prints a ``binning ...`` line (route, seconds); the Criteo data (shared
with the EFB phase) and the Covertype run pass ``tpu_ingest_device=false``,
since the engine skips the bundle probe for device-resident data. Each
training run sets the kernels' launch counts to 0 just before it
and reads them just after. The last two lines of standard output are the
per-kernel JSON line and the result line ``{"ok": true, "device":
{...}}``; any failure exits non-zero before the result line.
``--json-out PATH`` also writes the per-kernel record, replay included,
to PATH; ``--only-probes``, ``--only-sweep``, ``--only-objectives``,
``--only-categorical``, ``--only-efb``, ``--only-ranking`` and
``--only-bosch``, ``--only-ingest`` and ``--only-split-options`` build the
kernels, run phase 3, 7, 8, 9, 10, 11, 12, 13 or 14 and stop (no result
line). The whole script's
seconds are printed before the last two lines. It
needs a CUDA device and imports neither JAX nor ``lightgbm_tpu``.
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
# default size), SWEEP_ROUNDS rounds a run (6, down from 8 when the Bosch
# phase joined, to keep the whole script near 600 s)
SWEEP_ROWS = (2_000_000, 8_000_000, 10_000_000)
SWEEP_ROUNDS = 6
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
# the EFB phase: the Criteo shape with the suite's own enable_bundle
# (benchmarks/suite.py::bench_criteo); its 160 exclusive indicators bundle
# into 20 columns of 8, so the 199 logical features are 59 physical columns
EFB_PARAMS = dict(CRITEO_PARAMS, enable_bundle=True)
EFB_PHYS_COLS = 59
# EFB card against CPU (on PARITY_PARAMS, N_PARITY Criteo-shaped rows and 8
# sparse continuous columns): case -> (indicator flip share, CSR input,
# params); GOSS from iteration 1 / 0.3 = 3 of the 5. The objective is
# cross_entropy on the 0/1 label, and the masked case runs once more with
# binary: both sigmoids are XLA's algorithm in correctly rounded steps
# (objective/__init__.py::_sigmoid_xla), the same bits on card and CPU
EFB_PARITY_OBJECTIVE = {"objective": "cross_entropy"}
EFB_PARITY_CASES = {
    "masked": (0.0, False, {}),
    "goss": (0.0, False, {"data_sample_strategy": "goss",
                          "learning_rate": 0.3}),
    "partition": (0.0, False, {"tpu_hist_partition": "true"}),
    "exact": (0.0, False, {"use_quantized_grad": False}),
    "conflicts_0.2": (0.03, False, {"max_conflict_rate": 0.2,
                                    "tpu_hist_partition": "true"}),
    "csr_input": (0.0, True, {}),
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

# the Bosch phase: benchmarks/suite.py::bench_bosch (:58-105) at its own
# size and settings: 300,000 x 200 normal features (seed 1), the label
# 2 x0 + |x1| + 0.3 x2^2 + N(0, 0.5), feature 0 monotone increasing,
# regression, DART (max_drop 4, the other DART settings at their
# defaults) under GOSS with the compacted buffer, 127 leaves, 255 bins.
# 300k rows are below capabilities.AUTO_QUANT_MIN_ROWS, so kernel A runs
# in f32 mode at F = 200 and B compacts 200 bin rows. Warm BOSCH_WARM
# rounds (GOSS from iteration 1 / 0.1 = 10), time BOSCH_ROUNDS, trace
# TRACE_ROUNDS, record one more
N_BOSCH, BOSCH_F, BOSCH_WARM, BOSCH_ROUNDS = 300_000, 200, 14, 15
BOSCH_PARAMS = {"objective": "regression", "boosting": "dart",
                "data_sample_strategy": "goss", "num_leaves": 127,
                "max_bin": 255, "monotone_constraints": [1] + [0] * 199,
                "max_drop": 4, "learning_rate": 0.1, "verbosity": -1,
                "device_type": "cuda"}
# the response to feature 0 over this grid at BOSCH_GRID_ROWS random rows
# must not decrease by more than BOSCH_MONO_TOL
BOSCH_GRID, BOSCH_GRID_ROWS, BOSCH_MONO_TOL = 201, 5, 1e-6
# Bosch card against CPU: N_PARITY Bosch-shaped rows on PARITY_PARAMS at
# learning rate 0.3 (GOSS from iteration 3), drop rate 0.5 and skip_drop
# 0.2 so that trees drop in BOSCH_PARITY_ROUNDS rounds
BOSCH_PARITY_ROUNDS = 6
BOSCH_PARITY_PARAMS = dict(PARITY_PARAMS, objective="regression",
                           boosting="dart", learning_rate=0.3,
                           drop_rate=0.5, skip_drop=0.2, max_drop=4,
                           monotone_constraints=[1] + [0] * 199)
BOSCH_PARITY_CASES = {
    "dart_goss_monotone": {"data_sample_strategy": "goss"},
    "dart_masked": {},
    "dart_partition": {"tpu_hist_partition": "true"},
    "intermediate_batch8": {"monotone_constraints_method": "intermediate",
                            "tpu_leaf_batch": 8},
    "monotone_penalty_1": {"monotone_penalty": 1.0},
    "xgboost_dart_mode": {"xgboost_dart_mode": True},
    "binary_dart": {"objective": "binary"},
}


# the ingest phase: bench.py::main's default rows (--rows) at the
# flagship's 28 features, built three ways in turns; INGEST_ROUNDS rounds
# of the flagship's settings from the native and the device route; then
# a 1M-row matrix of edge values with two categorical columns
N_INGEST, N_INGEST_EDGE, INGEST_ROUNDS = 10_000_000, 1_000_000, 3
INGEST_CATS = [26, 27]

# the split options phase: the flagship's data and settings (PARAMS,
# N_TRAIN rows, N_HOLDOUT held out, binned once on the device route) with
# one option set a run, OPT_ROUNDS rounds (GOSS from iteration 1 / 0.1 =
# 10), each beside a plain flagship booster updated in turns with it,
# iteration for iteration. OPT_FORCED: a 3-level forced-split tree on
# features 0-2 (preorder: the root, its left subtree, its right subtree)
OPT_ROUNDS = 12
OPT_FORCED = {"feature": 0, "threshold": 0.0,
              "left": {"feature": 1, "threshold": 0.0,
                       "left": {"feature": 2, "threshold": -0.5},
                       "right": {"feature": 2, "threshold": 0.5}},
              "right": {"feature": 2, "threshold": 0.0,
                        "left": {"feature": 1, "threshold": -0.5},
                        "right": {"feature": 1, "threshold": 0.5}}}
OPT_RUNS = {
    "bynode_extra_trees": {"feature_fraction_bynode": 0.5,
                           "extra_trees": True},
    "path_smooth_contri": {"path_smooth": 50.0,
                           "feature_contri": [0.5] * 4 + [1.0] * 24},
    "interaction": {"interaction_constraints": [list(range(16)),
                                                list(range(12, 28))]},
    # gains grow with the rows: 1,000 a feature's first use, 1e-4 a row
    # of a split, 2e-4 a row that meets a feature first (at 200k rows a
    # fifth of these took the distinct features from 15 to 6)
    "cegb": {"cegb_penalty_split": 1e-4,
             "cegb_penalty_feature_coupled": [1000.0] * 28,
             "cegb_penalty_feature_lazy": [2e-4] * 28},
    "forced_partition": {"tpu_hist_partition": "true"},
}
# card against CPU (N_PARITY Higgs-shaped rows, 31 leaves, PARITY_ROUNDS
# rounds, learning rate 0.3 so that GOSS starts at iteration 3):
# case -> (data, params); the option sets cover every option on the
# masked, GOSS and partition paths, quantized and exact
OPT_SEARCH = {"feature_fraction_bynode": 0.6, "extra_trees": True,
              "path_smooth": 20.0,
              "feature_contri": [0.5] * 4 + [1.0] * 24}
OPT_LIMITS = {"interaction_constraints": [list(range(16)),
                                          list(range(12, 28))],
              "cegb_penalty_split": 1e-4,
              "cegb_penalty_feature_coupled": [20.0] * 28,
              "cegb_penalty_feature_lazy": [1e-3] * 28}
OPT_PATHS = {"masked": {}, "goss": {"data_sample_strategy": "goss"},
             "partition": {"tpu_hist_partition": "true"},
             "exact": {"use_quantized_grad": False}}
OPT_PARITY_CASES = dict(
    [(f"{name}_{path}", ("higgs", dict(opts, **extra)))
     for name, opts in (("search", OPT_SEARCH), ("limits", OPT_LIMITS),
                        ("forced", {"forcedsplits_filename": None}))
     for path, extra in OPT_PATHS.items()],
    categorical_bynode_extra=("guard", {"feature_fraction_bynode": 0.5,
                                        "extra_trees": True}),
    multiclass_lazy=("higgs3", {"objective": "multiclass", "num_class": 3,
                                "cegb_penalty_feature_lazy": [1e-3] * 28}),
    dart_bynode_interaction=("higgs", {
        "boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0,
        "feature_fraction_bynode": 0.6,
        "interaction_constraints": [list(range(16)), list(range(12, 28))]}))
OPT_PARITY_PARAMS = dict(PARITY_PARAMS, objective="binary",
                         learning_rate=0.3)

# the wide-bins phase: the flagship's data (N_TRAIN rows, N_HOLDOUT held
# out, binned on the device) at max_bin WIDE_MAX_BIN (every feature above
# 256 bins: uint16 ids) in turns with max_bin 255: WIDE_ROUNDS rounds of
# the flagship's GOSS settings (PARAMS, GOSS from iteration 10) and of
# full rows with the partition forced on (FULL_PARAMS), each wide booster
# updated in turns with its 255 twin, iteration for iteration; one traced
# and one recorded iteration more of each. Then synthetic kernel-A calls
# (B, F, n, K), the native route's construct at 1M and WIDE_NATIVE_ROWS
# rows, and the card against the CPU on N_PARITY rows
WIDE_MAX_BIN, WIDE_ROUNDS = 1023, 16
WIDE_SYNTH = ((4096, 2, 1_000_000, 32), (65_536, 2, 1_000_000, 32))
WIDE_NATIVE_ROWS = 10_000_000
WIDE_MODES = {"goss": dict(PARAMS),
              "partition": dict(FULL_PARAMS, tpu_hist_partition="true",
                                use_quantized_grad=True)}
# card against CPU: case -> (data, params), every path the port trains
WIDE_PARITY_CASES = {
    "masked": ("higgs", {"bagging_fraction": 0.7, "bagging_freq": 1,
                         "feature_fraction": 0.8}),
    "exact": ("higgs", {"use_quantized_grad": False}),
    "goss": ("higgs", {"data_sample_strategy": "goss"}),
    "partition": ("higgs", {"tpu_hist_partition": "true"}),
    "multiclass": ("higgs3", {"objective": "multiclass", "num_class": 3}),
    "dart": ("higgs", {"boosting": "dart", "drop_rate": 0.5,
                       "skip_drop": 0.0}),
    "categorical_1000": ("cat1000", {}),
    "bynode_extra_trees": ("higgs", {"feature_fraction_bynode": 0.6,
                                     "extra_trees": True}),
    "efb_wide_column": ("efb", {}),
}
WIDE_PARITY_PARAMS = dict(PARITY_PARAMS, objective="binary",
                          learning_rate=0.3, max_bin=WIDE_MAX_BIN)


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


def compaction_yardsticks(tc, bins, vals, keep, out_cols, k):
    """Kernel B's yardsticks on one compaction of ``k`` kept columns: the
    largest |difference| of one launch from the plain version, the plain
    version's and a mask select's ms, and the bound (the mask, the kept
    columns read once, the whole output, its tail zeros, written once)."""
    F, n = bins.shape
    C = vals.shape[0]
    gb, gv = tc.compact_by_mask(bins, vals, keep, out_cols)
    pb, pv = tc.compact_by_mask_plain(bins, vals, keep, out_cols)
    err = max(float((gb.int() - pb.int()).abs().max()),
              float((gv - pv).abs().max()))
    plain_ms = time_ms(lambda: tc.compact_by_mask_plain(
        bins, vals, keep, out_cols), reps=5)
    lib_ms = time_ms(lambda: (bins[:, keep], vals[:, keep]), reps=5)
    b_ms, b_by = bound(n + (F + 4 * C) * (k + out_cols), 0)
    return dict(plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err)


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
        y = compaction_yardsticks(tc, bins, vals, keep, out_cols, k)
        out[label] = dict(n=n, kept=k, out_cols=out_cols, ms=ms["kernel"],
                          earlier_ms=ms.get("parent_step"),
                          call_ms=call_ms["kernel"],
                          earlier_call_ms=call_ms.get("parent_step"),
                          turns=turns, **y)
        print(f"compaction {label} n={n} keep={k} out_cols={out_cols}: "
              f"device ms: compact_by_mask {ms['kernel']:.4f}"
              + (f", parent step (plan + zero-fills + kernel) "
                 f"{ms['parent_step']:.4f}, parent / kernel "
                 f"{ms['parent_step'] / ms['kernel']:.2f}"
                 if "parent_step" in ms else "")
              + f" (in turns {turns}); per call back to back: "
              + ", ".join(f"{x} {t:.4f}" for x, t in call_ms.items())
              + f"; plain {y['plain_ms']:.3f} ms, mask select "
              f"{y['library_ms']:.4f} ms, bound {y['bound_ms']:.4f} ms; "
              f"{REPEATS} launches bit-equal",
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
    device time (and kernel A's, ``hist_kernel``). The profiler's own host
    overhead is in the wall time. Device numbers are None when the trace
    holds no device events."""
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
                    kernel_a_ms_per_iter=None, dtoh_per_iter=None,
                    top_kernels=None)
    busy_ms = busy_us / 1e3 / rounds
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    step = {k: sum(us for name, us in per_name.items() if k in name)
            / 1e3 / rounds for k in STEP_KERNELS}
    return dict(
        wall_ms_per_iter=wall_ms, busy_ms_per_iter=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms, step_ms_per_iter=step,
        kernel_a_ms_per_iter=sum(us for name, us in per_name.items()
                                 if "hist_kernel" in name) / 1e3 / rounds,
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
    binning_line(f"flagship {N_TRAIN} x {N_FEAT}", ds)
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
    iteration, auto-quantized (kernel A in int mode, 9 calls a tree). EFB
    is on by default, so the 4 wilderness and 40 soil indicators bundle
    and kernel A scans the physical columns."""
    X, y = synth_covtype(N_COVTYPE + N_COVTYPE_HOLDOUT, seed=0)
    Xt, yt = X[:N_COVTYPE], y[:N_COVTYPE]
    Xv, yv = X[N_COVTYPE:], y[N_COVTYPE:]
    K = len(COVTYPE_SHARES)
    # host bins: the point of this run is EFB's 54 -> 12 columns, and the
    # engine skips the bundle probe for device-resident data
    ds = lgt.Dataset(Xt, label=yt, params={"tpu_ingest_device": "false"})
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
    # each held against the plain version at this shape (the physical
    # columns of the 54 features)
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
    f_phys = eng.data.bins_t.shape[0]
    r["held_against_plain"] = dict(calls=len(rec.calls), shapes=shapes,
                                   physical_columns=f_phys)
    print(f"objectives: multiclass: {len(rec.calls)} kernel-A calls of one "
          f"iteration (shapes F, n, C, lanes: {shapes}; {Xt.shape[1]} "
          f"features in {f_phys} physical columns, EFB "
          f"{eng.has_bundles}) held against the plain version: int mode "
          f"and exact-sum f32 mode bit-equal", flush=True)
    if len(rec.calls) < 2 * K or any(f != f_phys for f, *_ in shapes):
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
    r["binning"] = binning_line(f"Covertype {N_COVTYPE} x 54", ds)
    r["auto"] = multiclass_auto_run(lgt, th, tp, Xt, yt, Xv, yv, r, smi)
    return r


def multiclass_auto_run(lgt, th, tp, Xt, yt, Xv, yv, r_false, smi):
    """The Covertype run again under the default ``tpu_ingest_device=auto``:
    the card assigns the bins and the engine skips the EFB probe (the JAX
    package's rule), so kernel A scans all 54 columns. Its binning
    seconds, columns, it/s and holdout loss beside the ``false`` run's:
    what the rule costs this workload."""
    K = len(COVTYPE_SHARES)
    ds = lgt.Dataset(Xt, label=yt)
    ds.construct()
    b = binning_line(f"Covertype {N_COVTYPE} x 54, auto", ds)
    bst = lgt.Booster(params=dict(FULL_PARAMS, objective="multiclass",
                                  num_class=K, tpu_hist_partition="false",
                                  metric=["multi_logloss", "multi_error"]),
                      train_set=ds)
    bst.add_valid(ds.create_valid(Xv, label=yv), "holdout")
    eng = bst.engine
    cols = eng.data.bins_t.shape[0]
    if ds.device_ingested() is None or eng.has_bundles or cols != Xt.shape[1]:
        raise AssertionError(f"multiclass auto: device route "
                             f"{ds.device_ingested() is not None}, bundles "
                             f"{eng.has_bundles}, {cols} columns")
    a = timed_rounds(bst, MC_ROUNDS, th, tp)
    ev = {m: v for _, m, v, _ in bst.eval_valid()}
    f = r_false
    print(f"objectives: multiclass under tpu_ingest_device=auto: binning "
          f"{b['total']:.3f} s (false: {f['binning']['total']:.3f}), "
          f"{cols} physical columns (false: "
          f"{f['held_against_plain']['physical_columns']}), "
          f"{a['it_per_s']:.3f} it/s, after the first "
          f"{a['it_per_s_after_first']:.3f} (false: {f['it_per_s']:.3f} / "
          f"{f['it_per_s_after_first']:.3f}), holdout multi_logloss "
          f"{ev['multi_logloss']:.6f} (false: {f['multi_logloss']:.6f}), "
          f"multi_error {ev['multi_error']:.6f} (false: "
          f"{f['multi_error']:.6f}) on {smi}", flush=True)
    if not ev["multi_logloss"] < f["prior_logloss"]:
        raise AssertionError(f"multiclass auto holdout {ev}")
    return dict(binning=b, columns=cols, it_per_s=a["it_per_s"],
                it_per_s_after_first=a["it_per_s_after_first"],
                multi_logloss=ev["multi_logloss"],
                multi_error=ev["multi_error"], launches=a["launches"])


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


def criteo_data(lgt):
    """The Criteo shape's constructed Dataset (binned once, shared by the
    unbundled runs and the EFB phase), the rows the AUC is taken on and
    the seconds the data and binning took."""
    t0 = time.time()
    X, y = synth_criteo(N_CRITEO)
    # the EFB phase bundles this Dataset: host bins, since the engine
    # skips the bundle probe for device-resident data (the JAX package's
    # rule: probing would copy the matrix back to the host)
    ds = lgt.Dataset(X, label=y, categorical_feature=CRITEO_CATS,
                     params={"tpu_ingest_device": "false"})
    ds.construct()
    binning_line(f"Criteo {N_CRITEO} x 199", ds)
    Xa, ya = X[:CRITEO_AUC_ROWS], y[:CRITEO_AUC_ROWS]
    del X
    setup_s = time.time() - t0
    print(f"Criteo shape {N_CRITEO} x 199 (26 categorical): data and "
          f"binning {setup_s:.1f} s", flush=True)
    return dict(ds=ds, Xa=Xa, ya=ya, setup_s=setup_s)


def criteo_rounds(bst, path, th, tc, tp, Xa, ya, smi, label):
    """CRITEO_ROUNDS iterations of a Criteo-shaped booster (GOSS: 1 /
    learning rate more first, as GOSS starts there) from launch counts of
    0, then TRACE_ROUNDS traced ones: it/s after the first iteration
    (GOSS: of its GOSS iterations), AUC on the first rows, launches, the
    trace, and the model text (key ``text``)."""
    eng = bst.engine
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
    timed = secs[warm + 1:]
    r = dict(rounds=rounds, it_per_s_after_first=len(timed) / sum(timed),
             first_iter_s=secs[0], iter_s=[round(s, 4) for s in secs],
             auc_first_100k=auc_of(bst.predict(Xa), ya),
             cat_nodes=categorical_nodes(eng.models),
             nodes=sum(t.num_nodes for t in eng.models),
             launches=launches, hist_rows_scanned=eng.hist_rows_scanned,
             text=bst.model_to_string())
    print(f"{label} {path}: {rounds} rounds, "
          f"{r['it_per_s_after_first']:.3f} it/s "
          + ("(GOSS iterations after the first) " if warm
             else "(after the first iteration) ")
          + f"on {smi}; seconds per iteration {r['iter_s']}; AUC on the "
          f"first {CRITEO_AUC_ROWS} rows {r['auc_first_100k']:.6f}; "
          f"categorical splits {r['cat_nodes']} of {r['nodes']}; launches "
          f"{launches}", flush=True)
    tr = r["trace"] = trace_rounds(bst, TRACE_ROUNDS)
    print(f"{label} {path} traced ({TRACE_ROUNDS} more iterations): "
          f"{tr['wall_ms_per_iter']:.2f} ms wall, device busy "
          f"{tr['busy_ms_per_iter']} ms, idle share {tr['idle_share']}, "
          f"kernel A {tr['kernel_a_ms_per_iter']} ms, device ms per "
          f"iteration of the move and compaction kernels "
          f"{tr['step_ms_per_iter']}, device-to-host copies per iteration "
          f"{tr['dtoh_per_iter']}; top device time (ms per iteration): "
          f"{tr['top_kernels']}", flush=True)
    return r


def criteo_run(lgt, th, tc, tp, serial, gbdt, smi, data):
    """The Criteo shape on three paths, CRITEO_ROUNDS rounds each (the
    GOSS path 1 / learning rate more: GOSS starts there): it/s, AUC on the
    first 100k rows, launches, categorical splits and a trace; then one
    more iteration of each whose kernel-A calls (masked), compaction
    (GOSS) or partition moves (partition) are held against the plain
    versions at F = 199. The partition's text must equal the masked
    run's."""
    ds, Xa, ya, setup_s = (data[k] for k in ("ds", "Xa", "ya", "setup_s"))
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
                    and eng.num_features == 199 and not eng.has_bundles
                    and eng.hist_partition == (path == "partition")
                    and eng.use_goss_compact == (path == "goss")):
                raise AssertionError(f"criteo {path}: {eng.grow_cfg}")
            r = criteo_rounds(bst, path, th, tc, tp, Xa, ya, smi,
                              "categorical: Criteo")
            texts[path] = r.pop("text")
            # one more iteration with this path's kernel calls recorded
            rec.tag = "criteo_masked" if path == "masked" else None
            crec.on, prec.on = path == "goss", path == "partition"
            bst.update()
            rec.tag, crec.on, prec.on = None, False, False
            runs[path] = r
            launches = r["launches"]
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

    def node_uniforms(self, iteration, k, tag, C, F):
        u = np.random.default_rng([iteration, 1000 + k, tag]).random(
            (C, F), dtype=np.float32)
        return torch.from_numpy(u).to(self.device)

    def extra_uniforms(self, iteration, k, tag, C, F, extra_seed=6):
        u = np.random.default_rng([iteration, 2000 + k, tag,
                                   extra_seed]).random((C, F),
                                                       dtype=np.float32)
        return torch.from_numpy(u).to(self.device)


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


def categorical_phase(lgt, th, tc, tp, serial, gbdt, smi, criteo):
    """bench.py's categorical guard, the Criteo shape on three paths with
    its kernels held at F = 199, and categorical training on the card
    against the CPU."""
    t0 = time.time()
    res = {"guard": guard_run(lgt, th, smi),
           "criteo": criteo_run(lgt, th, tc, tp, serial, gbdt, smi, criteo),
           "card_vs_cpu": categorical_parity_run(lgt, th, tc, tp, smi)}
    res["seconds"] = time.time() - t0
    print(f"categorical phase: {res['seconds']:.1f} s", flush=True)
    return res


def efb_criteo_run(lgt, th, tc, tp, serial, gbdt, smi, data):
    """The Criteo shape with EFB on the masked, GOSS and partition paths,
    and the unbundled masked path beside them, on one constructed Dataset:
    CRITEO_ROUNDS rounds each (GOSS 1 / learning rate more first), traced;
    199 logical features must become EFB_PHYS_COLS physical columns that
    kernel A scans, B must not launch (GOSS stays masked under EFB) and
    B′ must move the physical columns under the partition, whose text
    must equal the masked run's; one more iteration's kernel-A calls
    (masked) and moves (partition) are held against the plain versions.
    Last, the bundled and unbundled masked paths run again in the
    reverse order, so their it/s come in turns (unbundled, EFB, EFB,
    unbundled)."""
    ds, Xa, ya = data["ds"], data["Xa"], data["ya"]
    runs, texts, plan = {}, {}, None
    rec = HistRecorder(serial, th)
    prec = CallRecorder(serial, "partition_move")
    paths = [("unbundled", CRITEO_PARAMS, "masked")] + [
        (p, EFB_PARAMS, p) for p in CRITEO_PATHS]
    try:
        for label, params, path in paths:
            bst = lgt.Booster(params=dict(params, **CRITEO_PATHS[path]),
                              train_set=ds)
            eng = bst.engine
            bundled = params is EFB_PARAMS
            f_rows = EFB_PHYS_COLS if bundled else 199
            if not (eng.has_bundles == bundled and eng.num_features == 199
                    and eng.data.bins_t.shape[0] == f_rows
                    and eng.data.bins.shape[1] == f_rows
                    and eng.grow_cfg.int_hist and eng.B == 256
                    and not (bundled and eng.use_goss_compact)
                    and eng.hist_partition == (path == "partition")):
                raise AssertionError(f"efb {label}: bundled "
                                     f"{eng.has_bundles}, bins "
                                     f"{tuple(eng.data.bins_t.shape)}")
            if bundled:
                plan = eng.bundle_plan
            r = criteo_rounds(bst, path, th, tc, tp, Xa, ya, smi,
                              "efb: Criteo" + ("" if bundled
                                               else " unbundled"))
            r["resident_bin_bytes"] = (eng.data.bins.numel()
                                       + eng.data.bins_t.numel())
            texts[label] = r.pop("text")
            if bundled:
                rec.tag = "efb_masked" if path == "masked" else None
                prec.on = path == "partition"
                bst.update()
                rec.tag, prec.on = None, False
            runs[label] = r
            launches = r["launches"]
            if not (launches["histogram"] > 0 and r["cat_nodes"] > 0
                    and math.isfinite(r["it_per_s_after_first"])
                    and r["auc_first_100k"] > 0.6):
                raise AssertionError(f"efb {label}: {r}")
            if launches["compact"] > 0 or \
                    (launches["partition"] > 0) != (path == "partition"):
                raise AssertionError(f"efb {label}: launches {launches}")
            del bst, eng
    finally:
        rec.close()
        prec.close()
    if texts["partition"] != texts["masked"]:
        raise AssertionError("efb: model text differs with the partition "
                             "on")
    turns = [runs["unbundled"]["it_per_s_after_first"],
             runs["masked"]["it_per_s_after_first"]]
    for params in (EFB_PARAMS, CRITEO_PARAMS):
        bst = lgt.Booster(params=dict(params, **CRITEO_PATHS["masked"]),
                          train_set=ds)
        turns.append(timed_rounds(bst, CRITEO_ROUNDS, th, tp)
                     ["it_per_s_after_first"])
        del bst
    print(f"efb: masked it/s in turns (unbundled, EFB, EFB, unbundled), "
          f"{CRITEO_ROUNDS} rounds each on {smi}: {turns}", flush=True)
    # each kernel-A call held bit-equal and timed beside the plain
    # version, index_add_ and the bound; each move held and timed
    replay = replay_phase(torch.device("cuda"), th, rec.calls, {})
    shapes = sorted({(*c["args"][0].shape, c["args"][1].shape[0],
                      c["args"][3].shape[0]) for c in rec.calls})
    held = dict(histogram_calls=len(rec.calls), histogram_shapes=shapes,
                replay=[{k: r[k] for k in REPLAY_KEYS} for r in replay],
                **hold_moves(tc, tp, [], prec.calls, label="efb"))
    held["move_times"] = time_moves(tp, prec.calls)
    ms = {k: r["trace"]["kernel_a_ms_per_iter"] for k, r in runs.items()}
    mib = {k: r["resident_bin_bytes"] / 2 ** 20 for k, r in runs.items()}
    mean = {m: sum(r[f"{m}_kernel_ms"] for r in replay) / len(replay)
            for m in ("int", "f32")}
    print(f"efb: Criteo {sum(len(b) for b in plan.bundles)} features in "
          f"{len(plan.bundles)} bundles, 199 -> {plan.n_phys} columns; "
          f"kernel A ms per iteration {ms} (unbundled: F = 199); resident "
          f"bins (row- and feature-major) MiB {mib}; {len(rec.calls)} "
          f"kernel-A calls of one masked iteration (shapes F, n, C, "
          f"lanes: {shapes}; int mode and exact-sum f32 mode bit-equal; "
          f"mean {mean['int']:.4f} ms int, {mean['f32']:.4f} ms f32 a "
          f"call) and partition moves {held['moves']} bit-equal to the "
          f"plain versions", flush=True)
    if not (len(rec.calls) >= 2 and prec.calls
            and all(f == EFB_PHYS_COLS for f, *_ in shapes)):
        raise AssertionError(f"efb recorded calls: {held}")
    return dict(runs, held_against_plain=held, n_phys=plan.n_phys,
                bundles=len(plan.bundles), partition_text_equal=True,
                masked_it_per_s_in_turns=turns)


def time_moves(tp, moves):
    """Device ms of the partition move on recorded moves (the inputs of
    one iteration), beside the plain version, three ``index_copy_`` (the
    destinations computed beforehand) and the bound: both leaf-id arrays,
    every column read and written once, the prefix sums written once."""
    out = []
    for bins, vals, old, new in moves:
        F, n = bins.shape
        C = vals.shape[0]
        dst = tuple(torch.empty_like(a) for a in (bins, vals, new))
        ms = device_ms(lambda: tp.partition_move(bins, vals, old, new,
                                                 out=dst))
        plain_ms = time_ms(lambda: tp.partition_move_plain(
            bins, vals, old, new), reps=2, warmup=1)
        d64 = tp.plan_split_move(new != old)[0].long()
        lib_ms = device_ms(lambda: (dst[0].index_copy_(1, d64, bins),
                                    dst[1].index_copy_(1, d64, vals),
                                    dst[2].index_copy_(0, d64, new)),
                           reps=5)
        b_ms, b_by = bound(n * ((F + 4 * C + 8) + (F + 4 * C + 4) + 4), 0)
        out.append(dict(F=F, n=n, moved=int((new != old).sum()), ms=ms,
                        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                        bound_by=b_by))
        print(f"efb: partition move F={F} n={n} moved {out[-1]['moved']}: "
              f"{ms:.4f} ms device, plain {plain_ms:.3f} ms, index_copy_ "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return out


def efb_parity_data(flip, seed=5):
    """N_PARITY + N_PARITY_HOLDOUT Criteo-shaped rows (``flip`` of the
    indicator entries set to 1) and 8 sparse continuous columns in two
    exclusive groups of 4 (one of a group non-zero on 2/3 of the rows,
    signed values on a grid of 0.25)."""
    n = N_PARITY + N_PARITY_HOLDOUT
    X, y = synth_criteo(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if flip:
        ind = X[:, 39:]
        ind[rng.random(ind.shape) < flip] = 1.0
    cols = [X]
    for _ in range(2):
        sel = rng.integers(0, 6, size=n)
        v = np.round(rng.lognormal(size=(n, 4)) * 4) / 4
        v *= np.where(rng.random((n, 4)) < 0.3, -1.0, 1.0)
        cols.append(np.where(sel[:, None] == np.arange(4)[None, :], v, 0.0))
    return np.hstack(cols), y


def efb_parity_run(lgt, th, tc, tp, smi):
    """Bundled training of 20k Criteo-shaped rows with sparse continuous
    columns, 5 rounds, on the card and on the CPU from the same draws: the
    masked, GOSS and partition paths, exact gradients, max_conflict_rate
    0.2 (lossy bundles) and CSR input. The same bundles, split lines
    identical (exact gradients: or every tree keeps the same rows in each
    leaf, as kernel A adds floats in another order than the plain
    version), predictions within PARITY_PRED_TOL; the masked case also
    with the binary objective."""
    import scipy.sparse as sp
    out = {}
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    cases = [(c, EFB_PARITY_OBJECTIVE) + v
             for c, v in EFB_PARITY_CASES.items()]
    cases.append(("binary_masked", {"objective": "binary"})
                 + EFB_PARITY_CASES["masked"])
    for case, obj, flip, csr, extra in cases:
        X, y = efb_parity_data(flip)
        Xt = sp.csr_matrix(X[:N_PARITY]) if csr else X[:N_PARITY]
        res = {}
        for dev in ("cuda", "cpu"):
            bst = lgt.train(
                dict(PARITY_PARAMS, device_type=dev, **obj, **extra),
                lgt.Dataset(Xt, label=y[:N_PARITY],
                            categorical_feature=CRITEO_CATS),
                num_boost_round=PARITY_ROUNDS, noise=SameDraws(dev))
            eng = bst.engine
            if not (eng.has_bundles and not eng.use_goss_compact
                    and eng.hist_partition == ("tpu_hist_partition"
                                               in extra)):
                raise AssertionError(f"efb card against CPU {case}: engine")
            res[dev] = (split_lines(bst.model_to_string()),
                        bst.predict(X[N_PARITY:]), eng.bundle_plan,
                        bst.predict(X[:N_PARITY], pred_leaf=True))
        equal = res["cuda"][0] == res["cpu"][0]
        same_rows = all(
            len(set(zip(a.tolist(), b.tolist())))
            == len(set(a.tolist())) == len(set(b.tolist()))
            for a, b in zip(res["cuda"][3].T, res["cpu"][3].T))
        diff = float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])
                            / np.maximum(1.0, np.abs(res["cpu"][1]))))
        plan = res["cpu"][2]
        out[case] = dict(split_lines_equal=equal, same_leaf_rows=same_rows,
                         max_rel_diff=diff, n_phys=plan.n_phys,
                         bundles=len(plan.bundles))
        print(f"efb: card against CPU, {case} ({obj['objective']}): "
              f"{plan.n_phys} physical columns of {X.shape[1]}, split lines "
              f"{'identical' if equal else 'DIFFER'}, the same rows in "
              f"every leaf {same_rows}, predictions max |diff| / max(1, "
              f"|CPU|) {diff:.3g}", flush=True)
        if not (res["cuda"][2].bundles == plan.bundles
                and (equal or (case == "exact" and same_rows))
                and diff <= PARITY_PRED_TOL):
            raise AssertionError(f"efb card against CPU, {case}: {out}")
    out["launches"] = {"histogram": th.multi_leaf_histogram.launches,
                       "compact": tc.compact_by_mask.launches,
                       "partition": tp.partition_move.launches}
    if not (out["launches"]["histogram"] > 0
            and out["launches"]["partition"] > 0
            and out["launches"]["compact"] == 0):
        raise AssertionError(f"efb card against CPU: launches "
                             f"{out['launches']}")
    return out


def efb_phase(lgt, th, tc, tp, serial, gbdt, smi, criteo):
    """Exclusive Feature Bundling at the Criteo shape, and bundled
    training (dense and CSR input) on the card against the CPU."""
    t0 = time.time()
    res = {"criteo": efb_criteo_run(lgt, th, tc, tp, serial, gbdt, smi,
                                    criteo),
           "card_vs_cpu": efb_parity_run(lgt, th, tc, tp, smi)}
    res["seconds"] = time.time() - t0
    print(f"efb phase: {res['seconds']:.1f} s", flush=True)
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
    binning_line(f"MSLR {n} x {MSLR_F}", ds)
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
    binning_line(f"MSLR lengths {ds.num_data} x {MSLR_F}", ds,
                 "24-26 s by the NumPy route")
    bst = lgt.Booster(params=dict(MSLR_PARAMS, **MSLR_PATHS["masked"]),
                      train_set=ds)
    eng = bst.engine
    Q, M = eng.objective.query_shape
    T = min(eng.objective.truncation, M)
    share = pair_share(counts, T)
    print(f"ranking: MSLR lengths: {len(counts)} queries, {ds.num_data} "
          f"rows x {MSLR_F} (mean {counts.mean():.1f}, longest {M} "
          f"documents): data {gen_s:.1f} s, binning {bin_s:.1f} s; "
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


# ---- phase 12: the Bosch configuration ------------------------------------
def bosch_data(n, seed=1):
    """benchmarks/suite.py::bench_bosch's data: (X ``[n, 200]``, y)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, BOSCH_F))
    y = (X[:, 0] * 2.0 + np.abs(X[:, 1]) + 0.3 * X[:, 2] ** 2
         + rng.normal(scale=0.5, size=n))
    return X, y


class DropTimer:
    """Takes the place of the name DART calls for the dropped trees'
    traversal (``boosting.dart.forest_predict_binned``), passes every call
    on, and records CUDA events around it: the device-timeline ms from the
    call's first kernel to its last (gaps while the host queues the
    traversal's small kernels included)."""

    def __init__(self, dart):
        self.dart, self.prev = dart, dart.forest_predict_binned
        self.events = []
        dart.forest_predict_binned = self

    def __call__(self, *args, **kw):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        out = self.prev(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def take_ms(self):
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in self.events)
        self.events = []
        return ms

    def close(self):
        self.dart.forest_predict_binned = self.prev


def time_compactions(tc, calls):
    """Device ms of kernel B on recorded compactions, beside the plain
    version, a mask select and the bound (the mask, the kept columns read
    once, the whole output written once)."""
    out = []
    for bins, vals, keep, out_cols in calls:
        F, n = bins.shape
        C = vals.shape[0]
        k = int(keep.sum())
        ms = device_ms(lambda: tc.compact_by_mask(bins, vals, keep,
                                                  out_cols))
        y = compaction_yardsticks(tc, bins, vals, keep, out_cols, k)
        out.append(dict(F=F, C=C, n=n, kept=k, out_cols=out_cols, ms=ms,
                        **y))
        print(f"bosch: compaction F={F} C={C} n={n} keep={k} "
              f"out_cols={out_cols}: {ms:.4f} ms device, plain "
              f"{y['plain_ms']:.3f} ms, mask select {y['library_ms']:.4f} "
              f"ms, bound {y['bound_ms']:.4f} ms ({y['bound_by']}); max "
              f"|diff| {y['max_abs_err']}", flush=True)
    return out


def hold_f32_calls(th, calls, label):
    """Kernel A in f32 mode on the recorded calls' own values against the
    plain version, within ``f32_tolerance``; returns the max |diff|."""
    err = 0.0
    for i, call in enumerate(calls):
        kw = dict(num_bins=call["kw"]["num_bins"])
        got = th.multi_leaf_histogram(*call["args"], **kw)
        ref = th.multi_leaf_histogram_plain(*call["args"], **kw)
        torch.cuda.synchronize()
        err = max(err, check_f32(f"{label} call {i} f32", got, ref,
                                 call["args"][1], False))
    return err


def bosch_response(bst, X):
    """The largest fall of the prediction along feature 0 over a
    BOSCH_GRID-point grid at BOSCH_GRID_ROWS random rows, and the
    responses' spread."""
    rows = X[np.random.default_rng(3).choice(len(X), BOSCH_GRID_ROWS,
                                             replace=False)]
    grid = np.linspace(-4.0, 4.0, BOSCH_GRID)
    Z = np.repeat(rows, BOSCH_GRID, axis=0)
    Z[:, 0] = np.tile(grid, BOSCH_GRID_ROWS)
    resp = bst.predict(Z).reshape(BOSCH_GRID_ROWS, BOSCH_GRID)
    return (float(max(0.0, -np.diff(resp, axis=1).min())),
            float(np.ptp(resp)))


def bosch_run(lgt, th, tc, tp, serial, gbdt, dart, smi):
    """The suite's Bosch configuration on the card: BOSCH_WARM rounds
    (one full-row iteration's kernel-A calls recorded), BOSCH_ROUNDS
    timed from launch counts of 0, TRACE_ROUNDS traced, then one GOSS
    iteration's kernel-A calls and compaction recorded and held against
    the plain versions (f32 mode within the tolerance on the recorded
    values; int mode and exact-sum f32 mode bit for bit; B bit for bit)
    and timed; train RMSE beside the label's std, as the suite reports
    them; the monotone response check."""
    t0 = time.time()
    X, y = bosch_data(N_BOSCH)
    ds = lgt.Dataset(X, label=y).construct()
    setup_s = time.time() - t0
    bst = lgt.Booster(params=dict(BOSCH_PARAMS), train_set=ds)
    eng = bst.engine
    if not (isinstance(eng, dart.DART) and eng.has_monotone
            and eng.num_features == BOSCH_F and not eng.has_bundles
            and not eng.grow_cfg.int_hist and eng.use_goss_compact
            and eng.grow_cfg.leaf_batch == 32):
        raise AssertionError(f"bosch engine: {eng.grow_cfg}")
    print(f"bosch: {N_BOSCH} x {BOSCH_F} (benchmarks/suite.py::bench_bosch"
          f"), DART + GOSS + monotone (+1 on feature 0): data and binning "
          f"{setup_s:.1f} s; GOSS buffer {eng.goss_n_sub} of "
          f"{eng.data.n_pad} padded rows", flush=True)
    binning_line(f"Bosch {N_BOSCH} x {BOSCH_F}", ds,
                 "28-30 s by the NumPy route")
    rec = HistRecorder(serial, th)
    modes = ModeCounter(serial, th)
    crec = CallRecorder(gbdt, "compact_by_mask")
    timer = DropTimer(dart)
    try:
        for i in range(BOSCH_WARM):
            rec.tag = "bosch_full_rows" if i == 1 else None
            bst.update()
        rec.tag = None
        timer.take_ms()
        th.multi_leaf_histogram.launches = 0
        tc.compact_by_mask.launches = 0
        tp.partition_move.launches = 0
        modes.calls = {"int": 0, "f32": 0}
        d0 = (eng.drop_iterations, eng.dropped_trees)
        secs = []
        for _ in range(BOSCH_ROUNDS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        drop_ms = timer.take_ms() / BOSCH_ROUNDS
        launches = {"histogram": th.multi_leaf_histogram.launches,
                    "compact": tc.compact_by_mask.launches,
                    "partition": tp.partition_move.launches}
        calls_by_mode = dict(modes.calls)
        drops = (eng.drop_iterations - d0[0], eng.dropped_trees - d0[1])
        tr = trace_rounds(bst, TRACE_ROUNDS)
        trace_drop_ms = timer.take_ms() / TRACE_ROUNDS
        rec.tag, crec.on = "bosch_goss", True
        bst.update()
        rec.tag, crec.on = None, False
    finally:
        timer.close()
        crec.close()
        modes.close()
        rec.close()
    r = dict(rounds=BOSCH_ROUNDS, iter_s=[round(x, 4) for x in secs],
             it_per_s=BOSCH_ROUNDS / sum(secs), launches=launches,
             kernel_a_calls_by_mode=calls_by_mode,
             drop_iterations=drops[0], dropped_trees=drops[1],
             drop_predict_ms_per_iter=drop_ms,
             drop_predict_ms_per_iter_traced=trace_drop_ms, trace=tr,
             setup_s=setup_s, goss_n_sub=eng.goss_n_sub,
             n_pad=eng.data.n_pad)
    t = time.time()
    pred = bst.predict(X)
    r["train_rmse"] = float(np.sqrt(np.mean((pred - y) ** 2)))
    r["label_std"] = float(y.std())
    r["predict_s"] = time.time() - t
    r["monotone_max_fall"], r["monotone_spread"] = bosch_response(bst, X)
    print(f"bosch: {BOSCH_ROUNDS} GOSS rounds, {r['it_per_s']:.3f} it/s on "
          f"{smi}; seconds per iteration {r['iter_s']}; train RMSE "
          f"{r['train_rmse']:.4f} (label std {r['label_std']:.4f}; predict "
          f"{r['predict_s']:.1f} s); {drops[0]} of {BOSCH_ROUNDS} "
          f"iterations dropped trees, {drops[1]} trees in all; dropped-tree "
          f"predict {drop_ms:.3f} ms an iteration (CUDA events; traced "
          f"iterations {trace_drop_ms:.3f}); launches {launches}, kernel A "
          f"calls by mode {calls_by_mode}; response to feature 0 over "
          f"{BOSCH_GRID} points at {BOSCH_GRID_ROWS} rows: largest fall "
          f"{r['monotone_max_fall']:.3g}, spread "
          f"{r['monotone_spread']:.4f}", flush=True)
    print(f"bosch: traced ({TRACE_ROUNDS} more iterations): "
          f"{tr['wall_ms_per_iter']:.2f} ms wall, device busy "
          f"{tr['busy_ms_per_iter']} ms, idle share {tr['idle_share']}, "
          f"kernel A {tr['kernel_a_ms_per_iter']} ms an iteration, move "
          f"and compaction kernels {tr['step_ms_per_iter']} ms an "
          f"iteration, device-to-host copies per iteration "
          f"{tr['dtoh_per_iter']}; top device time (ms per iteration): "
          f"{tr['top_kernels']}", flush=True)
    if not (launches["histogram"] > 0 and launches["compact"] > 0
            and launches["partition"] == 0 and calls_by_mode["int"] == 0
            and calls_by_mode["f32"] == launches["histogram"]
            and math.isfinite(r["it_per_s"])
            and r["train_rmse"] < r["label_std"]):
        raise AssertionError(f"bosch run: {r}")
    if r["monotone_max_fall"] > BOSCH_MONO_TOL or r["monotone_spread"] <= 0:
        raise AssertionError(f"bosch: the response to feature 0 falls by "
                             f"{r['monotone_max_fall']}")
    # the recorded calls: f32 mode on their own values within the
    # tolerance, then held bit for bit and timed beside the plain
    # version, index_add_ and the bound
    f32_err = hold_f32_calls(th, rec.calls, "bosch")
    replay = replay_phase(torch.device("cuda"), th, rec.calls, {})
    shapes = sorted({(*c["args"][0].shape, c["args"][1].shape[0],
                      c["args"][3].shape[0]) for c in rec.calls})
    held = dict(histogram_calls=len(rec.calls), histogram_shapes=shapes,
                f32_max_abs_err=f32_err,
                replay=[{k: x[k] for k in REPLAY_KEYS} for x in replay],
                **hold_moves(tc, tp, crec.calls, [], "bosch"))
    held["compaction_times"] = time_compactions(tc, crec.calls)
    by_tree = {}
    for x in replay:
        by_tree.setdefault(x["tree"], []).append(x)
    mean = {t: {m: sum(x[f"{m}_kernel_ms"] for x in xs) / len(xs)
                for m in ("int", "f32")} for t, xs in by_tree.items()}
    print(f"bosch: kernels at F = {BOSCH_F} held against the plain "
          f"versions: {len(rec.calls)} kernel-A calls (one full-row and "
          f"one GOSS iteration; shapes F, n, C, lanes: {shapes}; f32 mode "
          f"on the recorded values within the tolerance, max |diff| "
          f"{f32_err:.3g}; int mode and exact-sum f32 mode bit-equal; mean "
          f"ms a call by tree {mean}), compactions {held['compactions']} "
          f"bit-equal", flush=True)
    if not (len(by_tree) == 2 and all(f == BOSCH_F for f, *_ in shapes)
            and len(crec.calls) == 1
            and crec.calls[0][0].shape[0] == BOSCH_F):
        raise AssertionError(f"bosch recorded calls: {held}")
    return dict(r, held_against_plain=held)


def bosch_parity_data(seed=5, binary=False):
    """N_PARITY + N_PARITY_HOLDOUT Bosch-shaped rows; with ``binary`` the
    label is whether the regression label is above its median."""
    X, y = bosch_data(N_PARITY + N_PARITY_HOLDOUT, seed=seed)
    if binary:
        y = (y > np.median(y)).astype(np.float64)
    return X, y


def bosch_parity_run(lgt, th, tc, tp, dart, smi):
    """Every BOSCH_PARITY_CASES run on the card and on the CPU from the
    same draws: the same iterations drop trees, split lines identical,
    holdout predictions within PARITY_PRED_TOL."""
    out = {}
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    for case, extra in BOSCH_PARITY_CASES.items():
        X, y = bosch_parity_data(binary=extra.get("objective") == "binary")
        res, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.time()
            bst = lgt.train(dict(BOSCH_PARITY_PARAMS, device_type=dev,
                                 **extra),
                            lgt.Dataset(X[:N_PARITY], label=y[:N_PARITY]),
                            num_boost_round=BOSCH_PARITY_ROUNDS,
                            noise=SameDraws(dev))
            eng = bst.engine
            if not (isinstance(eng, dart.DART) and eng.has_monotone
                    and eng.hist_partition == ("tpu_hist_partition"
                                               in extra)):
                raise AssertionError(f"bosch card against CPU {case}: "
                                     "engine")
            res[dev] = (split_lines(bst.model_to_string()),
                        bst.predict(X[N_PARITY:]),
                        (eng.drop_iterations, eng.dropped_trees))
            secs[dev] = round(time.time() - t0, 1)
        equal = res["cuda"][0] == res["cpu"][0]
        diff = float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])
                            / np.maximum(1.0, np.abs(res["cpu"][1]))))
        out[case] = dict(split_lines_equal=equal, max_rel_diff=diff,
                         drops=res["cpu"][2])
        print(f"bosch: card against CPU, {case}: split lines "
              f"{'identical' if equal else 'DIFFER'}, predictions max "
              f"|diff| / max(1, |CPU|) {diff:.3g}, (iterations that "
              f"dropped, trees dropped) card {res['cuda'][2]} CPU "
              f"{res['cpu'][2]}; seconds {secs}", flush=True)
        if not (equal and diff <= PARITY_PRED_TOL
                and res["cuda"][2] == res["cpu"][2]
                and res["cpu"][2][0] > 0):
            raise AssertionError(f"bosch card against CPU, {case}: {out}")
    out["launches"] = {"histogram": th.multi_leaf_histogram.launches,
                       "compact": tc.compact_by_mask.launches,
                       "partition": tp.partition_move.launches}
    if not all(v > 0 for v in out["launches"].values()):
        raise AssertionError(f"bosch card against CPU: launches "
                             f"{out['launches']}")
    return out


def bosch_phase(lgt, th, tc, tp, serial, gbdt, smi):
    """The suite's Bosch configuration (DART + GOSS + monotone) on the
    card, and the seven 20k-row runs on the card against the CPU."""
    from lightgbm_tpu_torch.boosting import dart
    t0 = time.time()
    res = {"bosch": bosch_run(lgt, th, tc, tp, serial, gbdt, dart, smi),
           "card_vs_cpu": bosch_parity_run(lgt, th, tc, tp, dart, smi)}
    res["seconds"] = time.time() - t0
    print(f"bosch phase: {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# the ingest phase: host binning and device-side ingest at bench.py's size
# ---------------------------------------------------------------------------
def binning_line(label, ds, earlier=None):
    """One line of a dataset's construct seconds (bound search,
    assignment, whole) and route; ``earlier`` names PERF.md's figure for
    the same data before the native binner and device ingest."""
    s = ds.construct_seconds
    ing = ds.device_ingested()
    route = ("device" if ing is not None else "host native")
    extra = ""
    if ing is not None:
        ms = ("not measured" if ing.assign_ms is None
              else f"{ing.assign_ms:.2f} device ms")
        extra = (f"; {ing.chunks} chunks, {ing.h2d_bytes} H2D bytes, "
                 f"assignment {ms}")
    print(f"binning {label}: {route}, bounds {s['bounds']:.3f} s, "
          f"assignment {s['assign']:.3f} s, construct {s['total']:.3f} s"
          f"{extra}" + (f" (before: {earlier})" if earlier else ""),
          flush=True)
    return dict(s, route=route, assign_device_ms=(
        ing.assign_ms if ing is not None else None))


def plain_binned(X, params, categorical=(), mappers=None):
    """Route (a), the parent's: the NumPy bound search
    (``_greedy_find_distinct_bounds_plain``) and the NumPy assignment of
    one column at a time on a thread pool (``values_to_bins_plain``).
    Returns (bins ``[n, n_used]``, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from lightgbm_tpu_torch.io import binning
    t0 = time.perf_counter()
    if mappers is None:
        fast = binning._greedy_find_distinct_bounds
        binning._greedy_find_distinct_bounds = \
            binning._greedy_find_distinct_bounds_plain
        try:
            mappers = binning.mappers_from_params(
                X, params, categorical_idx=list(categorical))
        finally:
            binning._greedy_find_distinct_bounds = fast
    t1 = time.perf_counter()
    used = [i for i, m in enumerate(mappers) if not m.is_trivial]
    out = np.empty((X.shape[0], len(used)), np.uint8)

    def one(jf):
        j, f = jf
        out[:, j] = mappers[f].values_to_bins_plain(X[:, f])

    with ThreadPoolExecutor(binning.resolve_ingest_threads(0)) as ex:
        list(ex.map(one, enumerate(used)))
    t2 = time.perf_counter()
    return out, {"bounds": t1 - t0, "assign": t2 - t1, "total": t2 - t0}


def ingest_routes(lgt, X, y, label, categorical=(), reference=None):
    """Build the binned matrix of ``X`` three ways, in turns (a b c c b a):
    (a) the plain NumPy functions, (b) ``tpu_ingest_device=false`` (the
    native pass), (c) ``auto`` (the device). (c) must take the device
    route; the three ``bins`` and ``bins_t`` must be byte-equal. Returns
    the first (b) and (c) datasets and the seconds of every run."""
    dev = torch.device("cuda", 0)
    params = {"bin_construct_sample_cnt": 200_000}
    secs = {"plain": [], "native": [], "device": []}
    keep = {}
    for route in ("plain", "native", "device", "device", "native", "plain"):
        if route == "plain":
            bins, s = plain_binned(
                X, params, categorical,
                None if reference is None else reference.bin_mappers)
            if "plain" not in keep:
                keep["plain"] = bins
            secs["plain"].append(s)
            print(f"ingest {label} (a) plain NumPy: bounds {s['bounds']:.3f}"
                  f" s, assignment {s['assign']:.3f} s, construct "
                  f"{s['total']:.3f} s", flush=True)
            continue
        mode = "false" if route == "native" else "auto"
        ds = lgt.Dataset(X, label=y, reference=reference,
                         categorical_feature=list(categorical),
                         params=dict(params, tpu_ingest_device=mode))
        torch.cuda.synchronize()
        ds.construct()
        if (ds.device_ingested() is not None) != (route == "device"):
            raise AssertionError(f"ingest {label}: tpu_ingest_device={mode}"
                                 f" took the wrong route")
        secs[route].append(binning_line(
            f"ingest {label} ({'b' if route == 'native' else 'c'})", ds))
        keep.setdefault(route, ds)
        del ds
    host = keep["native"].binned
    if not np.array_equal(keep["plain"], host):
        raise AssertionError(f"ingest {label}: the native pass's bins differ"
                             f" from the plain NumPy functions'")
    ing = keep["device"].device_ingested()
    hb = torch.from_numpy(host).to(dev)
    same = (ing.bins.dtype == ing.bins_t.dtype == torch.uint8
            and torch.equal(ing.bins[:ing.n_rows], hb)
            and torch.equal(ing.bins_t[:, :ing.n_rows], hb.T))
    del hb
    if not same:
        raise AssertionError(f"ingest {label}: the device bins differ from "
                             f"the host's")
    print(f"ingest {label}: bins and bins_t byte-equal across the three "
          f"routes ({host.size} entries)", flush=True)
    return keep["native"], keep["device"], secs


def edge_matrix(n, seed=11):
    """1M x 28 float32 values (in float64) with NaN, +-0, +-inf, the float32
    values at and beside the bounds of ``base``'s mappers, and two
    categorical columns (NaN, unseen and negative ids among them)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, N_FEAT)).astype(np.float32).astype(np.float64)
    X[rng.random(n) < 0.05, 3] = np.nan
    X[rng.random(n) < 0.3, 4] = 0.0
    X[rng.random(n) < 0.1, 4] = -0.0
    X[rng.random(n) < 0.01, 5] = np.inf
    X[rng.random(n) < 0.01, 5] = -np.inf
    for c in INGEST_CATS:
        X[:, c] = rng.integers(0, 60, size=n)
        X[rng.random(n) < 0.02, c] = np.nan
    return X


def put_bound_values(X, mappers, rng):
    """Overwrite rows with the float32 neighbours of every bound (at and
    beside it) of each numerical column."""
    for f, m in enumerate(mappers):
        if m.bin_type != "numerical":
            continue
        ub = np.asarray(m.bin_upper_bound[:-1])
        near = ub.astype(np.float32)
        vals = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                               np.nextafter(near, np.float32(-np.inf))])
        rows = rng.choice(len(X), size=len(vals), replace=False)
        X[rows, f] = vals.astype(np.float64)
    X[rng.random(len(X)) < 0.01, INGEST_CATS[0]] = 1000.0   # unseen
    X[rng.random(len(X)) < 0.01, INGEST_CATS[1]] = -3.0


def ingest_phase(lgt, th, smi):
    """bench.py::main's default width, 10,000,000 x 28 Higgs-like rows
    (float64 holding float32 values): the binned matrix three ways in
    turns, byte-equal; the flagship's settings for INGEST_ROUNDS rounds
    from (b) and from (c) with equal model texts outside the parameters
    block, kernel A launching on the adopted ``bins_t``. Then the 1M x 28
    edge matrix, binned against fixed mappers, three ways."""
    t_phase = time.time()
    t0 = time.time()
    X, y = synth_higgs(N_INGEST, N_FEAT, seed=0)
    gen_s = time.time() - t0
    print(f"ingest: {N_INGEST} x {N_FEAT} (bench.py::main's default rows, "
          f"synth_higgs, float64 holding float32 values): data {gen_s:.1f} "
          f"s; {smi}", flush=True)
    ds_b, ds_c, secs = ingest_routes(lgt, X, y, f"{N_INGEST} rows")
    del X
    texts, runs = {}, {}
    for route, ds in (("native", ds_b), ("device", ds_c)):
        th.multi_leaf_histogram.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lgt.Booster(params=dict(PARAMS), train_set=ds)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng = bst.engine
        for _ in range(INGEST_ROUNDS):
            bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = th.multi_leaf_histogram.launches
        if launches == 0:
            raise AssertionError(f"ingest: kernel A never launched ({route})")
        if route == "device":
            ing = ds.device_ingested()
            if eng.data.bins_t.data_ptr() != ing.bins_t.data_ptr() \
                    or ds._binned is not None:
                raise AssertionError("ingest: the engine did not adopt the "
                                     "device bins")
        text = bst.model_to_string()
        head, rest = text.split("\nparameters:", 1)
        texts[route] = head + rest.split("end of parameters", 1)[1]
        runs[route] = dict(engine_init_s=init_s, train_s=wall,
                           kernel_a_launches=launches)
        tag = "b" if route == "native" else "c"
        print(f"ingest: flagship settings from ({tag}) {route}: engine "
              f"init {init_s:.3f} s, "
              f"{INGEST_ROUNDS} rounds {wall - init_s:.3f} s, kernel A "
              f"{launches} launches", flush=True)
        del bst, eng
    if texts["native"] != texts["device"]:
        raise AssertionError("ingest: model texts from (b) and (c) differ")
    print(f"ingest: model texts from (b) and (c) equal outside the "
          f"parameters block", flush=True)
    del ds_b, ds_c
    # the edge matrix, against the mappers of a first 1M-row set
    rng = np.random.default_rng(12)
    base = lgt.Dataset(edge_matrix(N_INGEST_EDGE, seed=11),
                       categorical_feature=INGEST_CATS,
                       params={"tpu_ingest_device": "false"}).construct()
    Xe = edge_matrix(N_INGEST_EDGE, seed=13)
    put_bound_values(Xe, base.bin_mappers, rng)
    ingest_routes(lgt, Xe, None, f"{N_INGEST_EDGE} edge rows",
                  categorical=INGEST_CATS,
                  reference=base)
    del Xe, base
    res = dict(rows=N_INGEST, features=N_FEAT, data_s=gen_s, seconds=secs,
               train=runs, phase_s=time.time() - t_phase)
    print(f"ingest phase: {res['phase_s']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# the split options phase: the split search's options at the flagship's
# shape, and on the card against the CPU
# ---------------------------------------------------------------------------
def forced_file(tmp):
    path = os.path.join(tmp, "forced.json")
    with open(path, "w") as fh:
        json.dump(OPT_FORCED, fh)
    return path


def forced_lines_hold(t):
    """Whether tree ``t`` starts with OPT_FORCED's lines: walked from the
    root, each node's feature, and the root's threshold within a bin
    width (0.05 at 255 bins of a normal feature) of the forced one."""
    def walk(node, spec):
        if spec is None:
            return True
        if node < 0 or int(t.split_feature[node]) != spec["feature"]:
            return False
        return (walk(int(t.left_child[node]), spec.get("left"))
                and walk(int(t.right_child[node]), spec.get("right")))
    return (t.num_leaves >= 8 and walk(0, OPT_FORCED)
            and abs(float(t.threshold_real[0]) - OPT_FORCED["threshold"])
            < 0.05)


def used_features(models):
    return sorted({int(f) for t in models
                   for f in t.split_feature[:t.num_nodes]})


def launch_counts(th, tc, tp):
    return (th.multi_leaf_histogram.launches, tc.compact_by_mask.launches,
            tp.partition_move.launches)


def options_run(lgt, th, tc, tp, serial, gbdt, smi, data, name, extra,
                trace_plain):
    """One option set at the flagship's shape: OPT_ROUNDS iterations of
    its booster and of a plain flagship booster in turns (launches of
    kernels A, B and B′ counted per booster from 0), it/s of each over
    the rounds after the first, holdout AUC, one traced GOSS iteration
    (device-to-host copies) of the option booster (and of the plain one
    when ``trace_plain``); for the bynode / extra_trees and forced runs
    one more GOSS iteration's kernel-A calls, compaction and partition
    moves are recorded and returned."""
    ds, vs, Xv, yv = data
    boosters = {"plain": lgt.Booster(params=dict(PARAMS), train_set=ds),
                name: lgt.Booster(params=dict(PARAMS, **extra),
                                  train_set=ds)}
    for b in boosters.values():
        b.add_valid(vs, "holdout")
    eng = boosters[name].engine
    if not (eng.use_goss_compact and eng.grow_cfg.int_hist
            and eng.hist_partition == ("tpu_hist_partition" in extra)):
        raise AssertionError(f"split options {name}: engine {eng.grow_cfg}")
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    secs = {k: [] for k in boosters}
    launches = {k: np.zeros(3, np.int64) for k in boosters}
    for _ in range(OPT_ROUNDS):
        for k, b in boosters.items():
            c0 = np.array(launch_counts(th, tc, tp))
            torch.cuda.synchronize()
            t = time.perf_counter()
            b.update()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t)
            launches[k] += np.array(launch_counts(th, tc, tp)) - c0
    r = {k: dict(it_per_s=(OPT_ROUNDS - 1) / sum(secs[k][1:]),
                 first_iter_s=secs[k][0],
                 launches=dict(zip(("histogram", "compact", "partition"),
                                   (int(x) for x in launches[k]))))
         for k in boosters}
    for k, b in boosters.items():
        [(_, _, auc, _)] = b.eval_valid()
        r[k]["auc"] = auc
        r[k]["features_used"] = used_features(b.engine.models)
    r[name]["trace"] = trace_rounds(boosters[name], 1)
    if trace_plain:
        r["plain"]["trace"] = trace_rounds(boosters["plain"], 1)
    rec = {}
    if name in ("bynode_extra_trees", "forced_partition"):
        hrec = HistRecorder(serial, th)
        crec = CallRecorder(gbdt, "compact_by_mask")
        prec = CallRecorder(serial, "partition_move")
        try:
            hrec.tag, crec.on, prec.on = name, True, True
            boosters[name].update()
        finally:
            hrec.close()
            crec.close()
            prec.close()
        rec = dict(hist=hrec.calls, compact=crec.calls, moves=prec.calls)
    o, p = r[name], r["plain"]
    tr = o["trace"]
    print(f"split options: {name} at {N_TRAIN} x {N_FEAT} (flagship "
          f"settings, GOSS from iteration 10): {o['it_per_s']:.3f} it/s "
          f"over rounds 2-{OPT_ROUNDS} beside the plain flagship's "
          f"{p['it_per_s']:.3f} in turns (first iterations "
          f"{o['first_iter_s']:.3f} / {p['first_iter_s']:.3f} s) on {smi}; "
          f"holdout AUC {o['auc']:.6f} (plain {p['auc']:.6f}); launches "
          f"{o['launches']} (plain {p['launches']}); one traced GOSS "
          f"iteration: {tr['wall_ms_per_iter']:.2f} ms wall, idle share "
          f"{tr['idle_share']}, device-to-host copies {tr['dtoh_per_iter']}"
          + (f" (plain {p['trace']['dtoh_per_iter']})" if trace_plain
             else "")
          + f"; distinct split features {len(o['features_used'])} (plain "
          f"{len(p['features_used'])})", flush=True)
    if not (o["launches"]["histogram"] > 0 and o["launches"]["compact"] > 0
            and (o["launches"]["partition"] > 0)
            == ("tpu_hist_partition" in extra)
            and math.isfinite(o["it_per_s"]) and o["auc"] > 0.75):
        raise AssertionError(f"split options {name}: {r}")
    return r, boosters[name], rec


def options_parity_data():
    """The card-against-CPU data: Higgs-shaped (binary and a 3-class label
    by the logit's terciles) and the categorical guard's (NaN in its
    categorical columns, a 3-way column)."""
    n = N_PARITY + N_PARITY_HOLDOUT
    X, y = synth_higgs(n, N_FEAT, seed=4)
    logit = synth_higgs(n, N_FEAT, seed=4, regression=True)[1]
    y3 = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])).astype(
        np.float64)
    Xg, yg, _ = synth_guard(n, seed=3, nan_cats=True, small_cat=True)
    return {"higgs": (X, y, []), "higgs3": (X, y3, []),
            "guard": (Xg, yg, list(range(10, Xg.shape[1])))}


def options_parity_run(lgt, th, tc, tp, smi, forced):
    """Every OPT_PARITY_CASES run on the card and on the CPU from the same
    draws (``SameDraws``, bynode's and extra_trees' included): split
    lines identical, predictions within PARITY_PRED_TOL. On exact
    gradients kernel A adds float32 values in another order than the
    plain version, so there a part is allowed where every tree puts the
    same training rows in each leaf."""
    data = options_parity_data()
    out = {}
    th.multi_leaf_histogram.launches = 0
    tc.compact_by_mask.launches = 0
    tp.partition_move.launches = 0
    for case, (which, extra) in OPT_PARITY_CASES.items():
        X, y, cats = data[which]
        if "forcedsplits_filename" in extra:
            extra = dict(extra, forcedsplits_filename=forced)
        res, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.time()
            bst = lgt.train(dict(OPT_PARITY_PARAMS, device_type=dev,
                                 **extra),
                            lgt.Dataset(X[:N_PARITY], label=y[:N_PARITY],
                                        categorical_feature=cats),
                            num_boost_round=PARITY_ROUNDS,
                            noise=SameDraws(dev))
            eng = bst.engine
            if eng.use_goss_compact != case.endswith("_goss") or \
                    eng.hist_partition != case.endswith("_partition"):
                raise AssertionError(f"split options card against CPU "
                                     f"{case}: engine paths")
            res[dev] = (split_lines(bst.model_to_string()),
                        bst.predict(X[N_PARITY:]),
                        bst.predict(X[:N_PARITY], pred_leaf=True),
                        [t for t in eng.models])
            secs[dev] = round(time.time() - t0, 1)
        equal = res["cuda"][0] == res["cpu"][0]
        same_rows = all(
            len(set(zip(a.tolist(), b.tolist())))
            == len(set(a.tolist())) == len(set(b.tolist()))
            for a, b in zip(res["cuda"][2].T, res["cpu"][2].T))
        diff = float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])
                            / np.maximum(1.0, np.abs(res["cpu"][1]))))
        forced_ok = all(forced_lines_hold(t) for t in res["cuda"][3]) \
            if "forcedsplits_filename" in extra else True
        out[case] = dict(split_lines_equal=equal, same_leaf_rows=same_rows,
                         max_rel_diff=diff, forced_lines=forced_ok)
        print(f"split options: card against CPU, {case}: split lines "
              f"{'identical' if equal else 'DIFFER'}, the same rows in "
              f"every leaf {same_rows}, predictions max |diff| / max(1, "
              f"|CPU|) {diff:.3g}"
              + ("" if "forcedsplits_filename" not in extra else
                 f", every tree starts with the forced lines {forced_ok}")
              + f"; seconds {secs}", flush=True)
        exact = extra.get("use_quantized_grad") is False
        if not ((equal or (exact and same_rows))
                and diff <= PARITY_PRED_TOL and forced_ok):
            raise AssertionError(f"split options card against CPU, "
                                 f"{case}: {out[case]}")
    out["launches"] = {"histogram": th.multi_leaf_histogram.launches,
                       "compact": tc.compact_by_mask.launches,
                       "partition": tp.partition_move.launches}
    print(f"split options: card against CPU, the card's launches "
          f"{out['launches']}", flush=True)
    if not all(v > 0 for v in out["launches"].values()):
        raise AssertionError(f"split options card against CPU: launches "
                             f"{out['launches']}")
    return out


def options_phase(lgt, th, tc, tp, serial, gbdt, smi):
    """Phase 14: the split search's options at the flagship's shape (five
    runs, each beside the plain flagship in turns), the kernels of runs
    (a) and (e) held against their plain versions, and the card against
    the CPU."""
    t0 = time.time()
    X, y = synth_higgs(N_TRAIN + N_HOLDOUT, N_FEAT, seed=0)
    ds = lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN])
    vs = ds.create_valid(X[N_TRAIN:], label=y[N_TRAIN:])
    ds.construct()
    binning_line(f"split options {N_TRAIN} x {N_FEAT}", ds)
    if ds.device_ingested() is None:
        raise AssertionError("split options: the flagship's data did not "
                             "take the device route")
    data = (ds, vs, X[N_TRAIN:], y[N_TRAIN:])
    del X, y
    runs, recs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        forced = forced_file(tmp)
        for i, (name, extra) in enumerate(OPT_RUNS.items()):
            if name == "forced_partition":
                extra = dict(extra, forcedsplits_filename=forced)
            r, bst, rec = options_run(lgt, th, tc, tp, serial, gbdt, smi,
                                      data, name, extra, i == 0)
            runs[name] = r
            if rec:
                recs[name] = rec
            eng = bst.engine
            if name == "cegb":
                used = used_features(eng.models)
                pen = eng._cegb_pen().cpu().numpy()
                zero = sorted(np.flatnonzero(pen == 0).tolist())
                r["cegb"]["coupled_zero"] = zero
                print(f"split options: cegb coupled penalty 0 for the "
                      f"{len(zero)} features in use {zero}, 1000 for the "
                      f"other {len(pen) - len(zero)}; distinct split "
                      f"features {len(used)} against the plain flagship's "
                      f"{len(r['plain']['features_used'])}", flush=True)
                if not (zero == used and (pen[pen != 0] == 1000.0).all()
                        and len(used) < len(r["plain"]["features_used"])):
                    raise AssertionError(f"split options cegb: {r}")
            if name == "forced_partition":
                ok = [forced_lines_hold(t) for t in eng.models]
                r[name]["trees_start_with_forced"] = sum(ok)
                print(f"split options: forced_partition: {sum(ok)} of "
                      f"{len(ok)} trees start with the 7 forced lines",
                      flush=True)
                if not all(ok):
                    raise AssertionError("split options: a tree does not "
                                         "start with the forced lines")
            del bst, eng
        del data, ds, vs
        rng, exact, held = np.random.default_rng(13), {}, {}
        for name, rec in recs.items():
            for i, call in enumerate(rec["hist"]):
                hold_call(th, call, f"split options {name} call {i}", rng,
                          exact)
            held[name] = dict(histogram_calls=len(rec["hist"]),
                              **hold_moves(tc, tp, rec["compact"],
                                           rec["moves"], name))
            print(f"split options: {name}: one GOSS iteration's "
                  f"{len(rec['hist'])} kernel-A calls (int mode and "
                  f"exact-sum f32 bit-equal), compactions "
                  f"{held[name]['compactions']} and partition moves "
                  f"{held[name]['moves']} bit-equal to the plain versions",
                  flush=True)
            if not (rec["hist"] and len(rec["compact"]) == 1
                    and bool(rec["moves"])
                    == (name == "forced_partition")):
                raise AssertionError(f"split options {name} recorded "
                                     f"calls: {held[name]}")
        parity = options_parity_run(lgt, th, tc, tp, smi, forced)
    res = dict(runs=runs, held_against_plain=held, card_vs_cpu=parity,
               seconds=time.time() - t0)
    print(f"split options phase: {res['seconds']:.1f} s", flush=True)
    return res


def wide_launches(th, tc, tp):
    """Launch counts of A, B and B′, all and uint16 ones."""
    return np.array([th.multi_leaf_histogram.launches,
                     th.multi_leaf_histogram.launches_u16,
                     tc.compact_by_mask.launches,
                     tc.compact_by_mask.launches_u16,
                     tp.partition_move.launches,
                     tp.partition_move.launches_u16], np.int64)


WIDE_KEYS = ("histogram", "histogram_u16", "compact", "compact_u16",
             "partition", "partition_u16")


def wide_data(lgt):
    """The flagship's data, binned on the device at WIDE_MAX_BIN and at
    255, twice in turns (construct seconds by route; a process's first
    device construct also loads torch's kernels: 144 device ms where this
    phase runs alone); the second pair trains."""
    X, y = synth_higgs(N_TRAIN + N_HOLDOUT, N_FEAT, seed=0)
    out = {}
    for tag, mb in (("wide", WIDE_MAX_BIN), ("narrow", 255),
                    ("wide", WIDE_MAX_BIN), ("narrow", 255)):
        ds = lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN],
                         params={"max_bin": mb})
        ds.construct()
        vs = ds.create_valid(X[N_TRAIN:], label=y[N_TRAIN:])
        ing = ds.device_ingested()
        want = torch.uint16 if mb > 255 else torch.uint8
        if ing is None or ing.bins.dtype != want:
            raise AssertionError(f"wide bins: max_bin {mb} did not take "
                                 f"the device route as {want}")
        nb = ds.feature_num_bins()
        earlier = out[tag]["binning"] if tag in out else []
        out[tag] = dict(ds=ds, vs=vs, binning=earlier + [binning_line(
            f"wide bins {N_TRAIN} x {N_FEAT} max_bin {mb}", ds)],
            num_bins=(int(nb.min()), int(nb.max())))
        print(f"wide bins: max_bin {mb}: {nb.min()}-{nb.max()} bins a "
              f"feature, {ing.bins.dtype} ids", flush=True)
    if out["wide"]["num_bins"][0] <= 256:
        raise AssertionError("wide bins: a feature has 256 bins or fewer")
    return out, X, y


def wide_pair(lgt, th, tc, tp, serial, gbdt, smi, data, mode):
    """One mode's wide booster in turns with its 255 twin: WIDE_ROUNDS
    updates each (launches per booster, it/s over the GOSS iterations or
    after the first), holdout AUC, resident bin bytes, one traced
    iteration each, then one recorded iteration each (kernel-A calls,
    the compaction or the partition moves)."""
    base = WIDE_MODES[mode]
    boosters = {}
    for tag in ("wide", "narrow"):
        mb = WIDE_MAX_BIN if tag == "wide" else 255
        b = lgt.Booster(params=dict(base, max_bin=mb),
                        train_set=data[tag]["ds"])
        b.add_valid(data[tag]["vs"], "holdout")
        boosters[tag] = b
    for tag, b in boosters.items():
        eng = b.engine
        want = torch.uint16 if tag == "wide" else torch.uint8
        if not (eng.data.bins_t.dtype == want
                and eng.use_goss_compact == (mode == "goss")
                and eng.hist_partition == (mode == "partition")
                and eng.grow_cfg.int_hist
                and eng.grow_cfg.leaf_batch == base["tpu_leaf_batch"]):
            raise AssertionError(f"wide bins {mode} {tag}: engine "
                                 f"{eng.grow_cfg}")
    secs = {k: [] for k in boosters}
    launches = {k: np.zeros(len(WIDE_KEYS), np.int64) for k in boosters}
    for _ in range(WIDE_ROUNDS):
        for k, b in boosters.items():
            c0 = wide_launches(th, tc, tp)
            torch.cuda.synchronize()
            t = time.perf_counter()
            b.update()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t)
            launches[k] += wide_launches(th, tc, tp) - c0
    # GOSS: its iterations after the first (whose first compaction of a
    # process's bin type loads the kernel's instance)
    first = int(1.0 / PARAMS["learning_rate"]) + 1 if mode == "goss" else 1
    r = {}
    for k, b in boosters.items():
        eng = b.engine
        [(_, _, auc, _)] = b.eval_valid()
        d = eng.data
        r[k] = dict(it_per_s=len(secs[k][first:]) / sum(secs[k][first:]),
                    iter_s=[round(x, 4) for x in secs[k]], auc=auc,
                    launches=dict(zip(WIDE_KEYS, (int(x)
                                                  for x in launches[k]))),
                    resident_bin_bytes=int(d.bins.nbytes
                                           + d.bins_t.nbytes),
                    B=eng.B)
        r[k]["trace"] = trace_rounds(b, 1)
    hrec = HistRecorder(serial, th)
    crec = CallRecorder(gbdt, "compact_by_mask")
    prec = CallRecorder(serial, "partition_move")
    rec = {}
    try:
        for k, b in boosters.items():
            hrec.tag, crec.on, prec.on = f"{mode}_{k}", True, True
            n0 = (len(hrec.calls), len(crec.calls), len(prec.calls))
            b.update()
            rec[k] = dict(hist=hrec.calls[n0[0]:],
                          compact=crec.calls[n0[1]:],
                          moves=prec.calls[n0[2]:])
            hrec.tag, crec.on, prec.on = None, False, False
    finally:
        hrec.close()
        crec.close()
        prec.close()
    w, n = r["wide"], r["narrow"]
    for k in r:
        tr = r[k]["trace"]
        print(f"wide bins: {mode} max_bin "
              f"{WIDE_MAX_BIN if k == 'wide' else 255} (B = {r[k]['B']}) "
              f"at {N_TRAIN} x {N_FEAT}: {r[k]['it_per_s']:.3f} it/s "
              f"({'GOSS iterations after the first' if mode == 'goss' else
                  'after the first'}, in turns with its twin; seconds "
              f"{r[k]['iter_s']}) on {smi}; holdout AUC "
              f"{r[k]['auc']:.6f}; launches {r[k]['launches']}; resident "
              f"bins {r[k]['resident_bin_bytes']} bytes; one traced "
              f"iteration: {tr['wall_ms_per_iter']:.2f} ms wall, kernel A "
              f"{tr['kernel_a_ms_per_iter']} ms, B / B′ "
              f"{tr['step_ms_per_iter']} ms, idle share {tr['idle_share']}, "
              f"device-to-host copies {tr['dtoh_per_iter']}; top device time "
              f"(ms) {tr['top_kernels']}", flush=True)
    need_b = mode == "goss"
    if not (w["launches"]["histogram_u16"] > 0
            and w["launches"]["histogram_u16"] == w["launches"]["histogram"]
            and (w["launches"]["compact_u16"] > 0) == need_b
            and (w["launches"]["partition_u16"] > 0) == (not need_b)
            and n["launches"]["histogram_u16"] == 0
            and n["launches"]["compact_u16"] == 0
            and n["launches"]["partition_u16"] == 0
            and math.isfinite(w["it_per_s"]) and w["auc"] > 0.75
            and abs(w["auc"] - n["auc"]) < 0.02
            and w["resident_bin_bytes"] == 2 * n["resident_bin_bytes"]):
        raise AssertionError(f"wide bins {mode}: {r}")
    if not (rec["wide"]["hist"] and (len(rec["wide"]["compact"]) == 1)
            == need_b and bool(rec["wide"]["moves"]) == (not need_b)):
        counts = {k: len(v) for k, v in rec["wide"].items()}
        raise AssertionError(f"wide bins {mode}: recorded calls {counts}")
    return r, rec


def wide_hist_calls(th, calls, twin, label):
    """Kernel A on one recorded iteration of a wide run: int mode and
    exact-sum f32 bit-equal, f32 on the recorded values within the
    tolerance; device ms (int, f32) beside the plain version, an int
    ``index_add_`` and the bound (2-byte bins); the 255 twin's call of the
    same index timed as uint8, and as uint16 at its B."""
    rng = np.random.default_rng(15)
    exact, rows = {}, []
    for i, call in enumerate(calls):
        bins, vals, leaf, ids = call["args"]
        B = call["kw"]["num_bins"]
        F, n = bins.shape
        C, K = vals.shape[0], ids.shape[0]
        hold_call(th, call, f"{label} call {i}", rng, exact)
        err = hold_f32_calls(th, [call], f"{label} call {i}")
        kw = dict(num_bins=B)
        r = dict(n=n, F=F, B=B, K=K, live_lanes=int(
            torch.unique(ids[ids >= 0]).numel()), f32_max_abs_err=err)
        r["int_ms"] = device_ms(lambda: th.multi_leaf_histogram(
            bins, vals, leaf, ids, int_mode=True, **kw), reps=10)
        r["f32_ms"] = device_ms(lambda: th.multi_leaf_histogram(
            bins, vals, leaf, ids, **kw), reps=10)
        r["plain_ms"] = time_ms(lambda: th.multi_leaf_histogram_plain(
            bins, vals, leaf, ids, int_mode=True, **kw), reps=2, warmup=1)
        idx, src, m, pairs = lane_index(bins.to(torch.int32), vals, leaf,
                                        ids, B)
        buf = torch.zeros(K * F * B * C, dtype=torch.int32,
                          device=bins.device)
        src = src.to(torch.int32)
        r["library_ms"] = time_ms(lambda: buf.index_add_(0, idx, src),
                                  reps=5)
        del idx, src, buf
        nbytes = 4 * n + (2 * F + 4 * C) * m + 4 * K + 4 * K * F * B * C
        r["bound_ms"], r["bound_by"] = bound(nbytes, pairs * F * C)
        r["matched_rows"] = m
        r["scratch_bytes"] = int(
            th._lib().lgbt_multi_leaf_histogram_u16_scratch(
                bins.data_ptr(), vals.data_ptr(), leaf.data_ptr(), n, F, C,
                K, B))
        if i < len(twin):
            tb_, tv, tl, ti = twin[i]["args"]
            tB = twin[i]["kw"]["num_bins"]
            r["u8_B"], r["u8_n"] = tB, tb_.shape[1]
            r["u8_int_ms"] = device_ms(lambda: th.multi_leaf_histogram(
                tb_, tv, tl, ti, num_bins=tB, int_mode=True), reps=10)
            t16 = tb_.to(torch.int16).view(torch.uint16)
            r["u16_at_u8_B_int_ms"] = device_ms(
                lambda: th.multi_leaf_histogram(t16, tv, tl, ti,
                                                num_bins=tB, int_mode=True),
                reps=10)
            got = th.multi_leaf_histogram(t16, tv, tl, ti, num_bins=tB,
                                          int_mode=True)
            ref = th.multi_leaf_histogram(tb_, tv, tl, ti, num_bins=tB,
                                          int_mode=True)
            if not torch.equal(got, ref):
                raise AssertionError(f"{label} call {i}: uint16 and uint8 "
                                     f"bins of the same ids differ")
            del t16, got, ref
        rows.append(r)
        print(f"wide bins: {label} call {i} n={n} F={F} B={B} live lanes "
              f"{r['live_lanes']}/{K}, matched rows {m}: kernel int "
              f"{r['int_ms']:.4f} / f32 {r['f32_ms']:.4f} ms device (f32 "
              f"max |diff| {err:.3g} within tolerance; int and exact-sum "
              f"f32 bit-equal), plain {r['plain_ms']:.3f} ms, index_add_ "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), scratch {r['scratch_bytes']} bytes"
              + (f"; the 255 twin's call {i} (n={r['u8_n']}, B="
                 f"{r['u8_B']}): uint8 {r['u8_int_ms']:.4f} ms, its bins as "
                 f"uint16 {r['u16_at_u8_B_int_ms']:.4f} ms"
                 if "u8_int_ms" in r else ""), flush=True)
    return rows


def wide_moves(tc, tp, tb, compactions, moves, label):
    """B and B′ on the recorded wide calls: bit-equal to the plain
    versions (``hold_moves``), device ms of the uint16 launch beside the
    same call on the ids' low bytes (uint8), the plain version, the
    library call (mask select / three ``index_copy_``, on the bins' int16
    view) and the bound (2-byte rows)."""
    held = hold_moves(tc, tp, compactions, moves, label)
    comp, mov = [], []
    for bins, vals, keep, out_cols in compactions:
        F, n = bins.shape
        C = vals.shape[0]
        k = int(keep.sum())
        b8 = bins.view(torch.int16).to(torch.uint8)
        r = dict(F=F, C=C, n=n, kept=k, out_cols=out_cols)
        r["ms"] = device_ms(lambda: tc.compact_by_mask(bins, vals, keep,
                                                       out_cols))
        r["u8_ms"] = device_ms(lambda: tc.compact_by_mask(b8, vals, keep,
                                                          out_cols))
        r["plain_ms"] = time_ms(lambda: tc.compact_by_mask_plain(
            bins, vals, keep, out_cols), reps=5)
        mb = tb.movable(bins)
        r["library_ms"] = time_ms(lambda: (mb[:, keep], vals[:, keep]),
                                  reps=5)
        r["bound_ms"], r["bound_by"] = bound(
            n + (2 * F + 4 * C) * (k + out_cols), 0)
        comp.append(r)
        print(f"wide bins: {label} compaction F={F} (2-byte rows) C={C} "
              f"n={n} keep={k} out_cols={out_cols}: {r['ms']:.4f} ms device "
              f"(uint8 rows {r['u8_ms']:.4f}), plain {r['plain_ms']:.3f} "
              f"ms, mask select {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms; bit-equal", flush=True)
    for bins, vals, old, new in moves:
        F, n = bins.shape
        C = vals.shape[0]
        b8 = bins.view(torch.int16).to(torch.uint8)
        dst = tuple(torch.empty_like(a) for a in (bins, vals, new))
        dst8 = (torch.empty_like(b8),) + dst[1:]
        r = dict(F=F, n=n, moved=int((new != old).sum()))
        r["ms"] = device_ms(lambda: tp.partition_move(bins, vals, old, new,
                                                      out=dst))
        r["u8_ms"] = device_ms(lambda: tp.partition_move(b8, vals, old, new,
                                                         out=dst8))
        r["plain_ms"] = time_ms(lambda: tp.partition_move_plain(
            bins, vals, old, new), reps=2, warmup=1)
        d64 = tp.plan_split_move(new != old)[0].long()
        mb, md = tb.movable(bins), tb.movable(dst[0])
        r["library_ms"] = device_ms(lambda: (md.index_copy_(1, d64, mb),
                                             dst[1].index_copy_(1, d64, vals),
                                             dst[2].index_copy_(0, d64, new)),
                                    reps=5)
        r["bound_ms"], r["bound_by"] = bound(
            n * ((2 * F + 4 * C + 8) + (2 * F + 4 * C + 4) + 4), 0)
        mov.append(r)
        print(f"wide bins: {label} partition move F={F} (2-byte rows) n={n} "
              f"moved {r['moved']}: {r['ms']:.4f} ms device (uint8 rows "
              f"{r['u8_ms']:.4f}), plain {r['plain_ms']:.3f} ms, index_copy_ "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; "
              f"bit-equal", flush=True)
    return dict(held, compaction_times=comp, move_times=mov)


def wide_synthetic(th, dev):
    """Kernel A at WIDE_SYNTH's shapes (uint16, ids of 32,768 and more at
    B = 65,536): int and exact-sum f32 bit-equal to the plain version,
    device ms beside the plain version, an ``index_add_`` and the bound."""
    rng = np.random.default_rng(16)
    out = []
    for B, F, n, K in WIDE_SYNTH:
        bins = torch.from_numpy(rng.integers(0, B, size=(F, n)).astype(
            np.uint16)).to(dev)
        leaf = torch.from_numpy(rng.integers(0, 40, size=n).astype(
            np.int32)).to(dev)
        ids = torch.arange(K, dtype=torch.int32, device=dev)
        dead = [i for i in INACTIVE_LANES if i < K]
        ids[dead] = -1
        vals = torch.from_numpy(rng.integers(-3, 4, size=(3, n)).astype(
            np.float32)).to(dev)
        call = dict(args=(bins, vals, leaf, ids), kw=dict(num_bins=B))
        hold_call(th, call, f"wide bins synthetic B={B}", rng, {})
        r = dict(B=B, F=F, n=n, K=K)
        r["int_ms"] = device_ms(lambda: th.multi_leaf_histogram(
            bins, vals, leaf, ids, num_bins=B, int_mode=True), reps=10)
        r["f32_ms"] = device_ms(lambda: th.multi_leaf_histogram(
            bins, vals, leaf, ids, num_bins=B), reps=10)
        r["plain_ms"] = time_ms(lambda: th.multi_leaf_histogram_plain(
            bins, vals, leaf, ids, num_bins=B, int_mode=True), reps=2,
            warmup=1)
        idx, src, m, pairs = lane_index(bins.to(torch.int32), vals, leaf,
                                        ids, B)
        buf = torch.zeros(K * F * B * 3, dtype=torch.int32, device=dev)
        src = src.to(torch.int32)
        r["library_ms"] = time_ms(lambda: buf.index_add_(0, idx, src),
                                  reps=5)
        del idx, src, buf
        nbytes = 4 * n + (2 * F + 12) * m + 4 * K + 4 * K * F * B * 3
        r["bound_ms"], r["bound_by"] = bound(nbytes, pairs * F * 3)
        r["matched_rows"] = m
        r["scratch_bytes"] = int(
            th._lib().lgbt_multi_leaf_histogram_u16_scratch(
                bins.data_ptr(), vals.data_ptr(), leaf.data_ptr(), n, F, 3,
                K, B))
        out.append(r)
        print(f"wide bins: synthetic A B={B} F={F} n={n} K={K} "
              f"({K - len(dead)} live, matched rows {m}): int "
              f"{r['int_ms']:.4f} / f32 {r['f32_ms']:.4f} ms device, plain "
              f"{r['plain_ms']:.3f} ms, index_add_ {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), scratch "
              f"{r['scratch_bytes']} bytes; int and exact-sum f32 bit-equal",
              flush=True)
        del bins, leaf, vals
    return out


def wide_native(lgt, X, y, ds_wide):
    """The native host route at WIDE_MAX_BIN (its scalar search) at 1M
    rows, byte-equal to the device route's bins, and at WIDE_NATIVE_ROWS
    rows in turns with max_bin 255 (its branchless pass)."""
    out = {}
    ds = lgt.Dataset(X[:N_TRAIN], label=y[:N_TRAIN], params={
        "max_bin": WIDE_MAX_BIN, "tpu_ingest_device": "false"}).construct()
    if ds.device_ingested() is not None or ds.binned.dtype != np.uint16 \
            or not np.array_equal(ds.binned, ds_wide.binned):
        raise AssertionError("wide bins: the native route's bins differ "
                             "from the device route's")
    out["native_1M"] = binning_line(
        f"wide bins {N_TRAIN} x {N_FEAT} max_bin {WIDE_MAX_BIN}", ds)
    del ds
    Xb, yb = synth_higgs(WIDE_NATIVE_ROWS, N_FEAT, seed=5)
    for mb in (WIDE_MAX_BIN, 255, WIDE_MAX_BIN):
        ds = lgt.Dataset(Xb, label=yb, params={
            "max_bin": mb, "tpu_ingest_device": "false"}).construct()
        out.setdefault(f"native_10M_{mb}", []).append(binning_line(
            f"wide bins {WIDE_NATIVE_ROWS} x {N_FEAT} max_bin {mb}", ds))
        del ds
    del Xb, yb
    return out


def wide_parity_data():
    n = N_PARITY + N_PARITY_HOLDOUT
    X, y = synth_higgs(n, N_FEAT, seed=4)
    logit = synth_higgs(n, N_FEAT, seed=4, regression=True)[1]
    y3 = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])).astype(
        np.float64)
    rng = np.random.default_rng(6)
    Xc = X.copy()
    Xc[:, 27] = rng.integers(0, 1000, size=n)
    Xc[rng.random(n) < 0.05, 27] = np.nan
    yc = ((logit + (Xc[:, 27] % 7 < 2) * 1.5 > np.median(logit))
          .astype(np.float64))
    Xe = np.zeros((n, 12))
    Xe[:, :4] = X[:, :4]
    grp = rng.integers(0, 9, size=n)
    for j in range(8):
        # one decimal: some 60 bins a column, so they bundle (256 at most)
        Xe[grp == j, 4 + j] = np.round(
            rng.normal(size=int((grp == j).sum())) + 2.0, 1)
    ye = (Xe[:, 0] + Xe[:, 4] - Xe[:, 7] + rng.normal(size=n) > 0) \
        .astype(np.float64)
    return {"higgs": (X, y, []), "higgs3": (X, y3, []),
            "cat1000": (Xc, yc, [27]), "efb": (Xe, ye, [])}


def wide_parity_run(lgt, th, tc, tp, smi):
    """Every WIDE_PARITY_CASES run on the card and on the CPU from the
    same draws: split lines identical (exact gradients: or the same rows
    in every leaf), predictions within PARITY_PRED_TOL; the card's runs
    launch the uint16 kernels."""
    data = wide_parity_data()
    out = {}
    c0 = wide_launches(th, tc, tp)
    for case, (which, extra) in WIDE_PARITY_CASES.items():
        X, y, cats = data[which]
        res = {}
        for dev in ("cuda", "cpu"):
            bst = lgt.train(dict(WIDE_PARITY_PARAMS, device_type=dev,
                                 **extra),
                            lgt.Dataset(X[:N_PARITY], label=y[:N_PARITY],
                                        categorical_feature=cats),
                            num_boost_round=PARITY_ROUNDS,
                            noise=SameDraws(dev))
            eng = bst.engine
            if eng.data.bins.dtype != torch.uint16 or \
                    eng.use_goss_compact != (case == "goss") or \
                    eng.hist_partition != (case == "partition") or \
                    eng.has_bundles != (case == "efb_wide_column"):
                raise AssertionError(f"wide bins card against CPU {case}: "
                                     f"engine paths")
            res[dev] = (split_lines(bst.model_to_string()),
                        bst.predict(X[N_PARITY:]),
                        bst.predict(X[:N_PARITY], pred_leaf=True))
        equal = res["cuda"][0] == res["cpu"][0]
        same_rows = all(
            len(set(zip(a.tolist(), b.tolist())))
            == len(set(a.tolist())) == len(set(b.tolist()))
            for a, b in zip(res["cuda"][2].T, res["cpu"][2].T))
        diff = float(np.max(np.abs(res["cuda"][1] - res["cpu"][1])
                            / np.maximum(1.0, np.abs(res["cpu"][1]))))
        out[case] = dict(split_lines_equal=equal, same_leaf_rows=same_rows,
                         max_rel_diff=diff)
        print(f"wide bins: card against CPU, {case}: split lines "
              f"{'identical' if equal else 'DIFFER'}, the same rows in "
              f"every leaf {same_rows}, predictions max |diff| / max(1, "
              f"|CPU|) {diff:.3g}", flush=True)
        exact = extra.get("use_quantized_grad") is False
        if not ((equal or (exact and same_rows))
                and diff <= PARITY_PRED_TOL):
            raise AssertionError(f"wide bins card against CPU, {case}: "
                                 f"{out[case]}")
    out["launches"] = dict(zip(WIDE_KEYS, (int(x) for x in
                                           wide_launches(th, tc, tp) - c0)))
    print(f"wide bins: card against CPU, the card's launches "
          f"{out['launches']}", flush=True)
    if not all(out["launches"][k] > 0 for k in ("histogram_u16",
                                                 "compact_u16",
                                                 "partition_u16")):
        raise AssertionError(f"wide bins card against CPU: launches "
                             f"{out['launches']}")
    return out


def wide_phase(lgt, th, tc, tp, serial, gbdt, smi, dev):
    """Phase 15: wide bins. The flagship's 1M x 28 at max_bin 1023 in
    turns with 255 (GOSS; full rows with the partition on), one recorded
    iteration of each wide run's kernels held against their plain
    versions and timed beside their uint8 times, synthetic A calls at
    B = 4096 and 65,536, the native route's construct, and the card
    against the CPU."""
    from lightgbm_tpu_torch.ops import bins as tb
    t0 = time.time()
    data, X, y = wide_data(lgt)
    th.multi_leaf_histogram.launches = 0
    th.multi_leaf_histogram.launches_u16 = 0
    tc.compact_by_mask.launches = 0
    tc.compact_by_mask.launches_u16 = 0
    tp.partition_move.launches = 0
    tp.partition_move.launches_u16 = 0
    runs, recs = {}, {}
    for mode in WIDE_MODES:
        runs[mode], recs[mode] = wide_pair(lgt, th, tc, tp, serial, gbdt,
                                           smi, data, mode)
    main_launches = dict(zip(WIDE_KEYS, (int(x) for x in
                                         wide_launches(th, tc, tp))))
    print(f"wide bins: the main path's launches (both modes, wide and 255 "
          f"twins, from 0): {main_launches}", flush=True)
    held = {}
    for mode, rec in recs.items():
        held[mode] = dict(
            hist=wide_hist_calls(th, rec["wide"]["hist"],
                                 rec["narrow"]["hist"], f"{mode} wide"),
            **wide_moves(tc, tp, tb, rec["wide"]["compact"],
                         rec["wide"]["moves"], f"{mode} wide"))
    del recs
    synth = wide_synthetic(th, dev)
    native = dict(wide_native(lgt, X, y, data["wide"]["ds"]), **{
        f"device_1M_{k}": v["binning"] for k, v in data.items()})
    del data, X, y
    parity = wide_parity_run(lgt, th, tc, tp, smi)
    res = dict(runs=runs, main_launches=main_launches,
               held_against_plain=held, synthetic=synth, binning=native,
               card_vs_cpu=parity, seconds=time.time() - t0)
    print(f"wide bins phase: {res['seconds']:.1f} s", flush=True)
    return res


def wide_entries(wide):
    """The kernels line's entries of the uint16 variants: launches from
    the phase's main-path runs, times the means over the recorded
    iteration's calls (A: the GOSS run's; B: its compaction; B′: the
    partition run's moves)."""
    def mean(rows, k):
        return sum(r[k] for r in rows) / len(rows)
    h = wide["held_against_plain"]
    ga, comp = h["goss"]["hist"], h["goss"]["compaction_times"]
    moves = h["partition"]["move_times"]
    L = wide["main_launches"]
    common = dict(route="cuda", bound_by="bytes")
    return [
        dict(name="multi_leaf_histogram_u16",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:80",
             launches=L["histogram_u16"], max_abs_err=0.0,
             ms=mean(ga, "int_ms"), plain_ms=mean(ga, "plain_ms"),
             bound_ms=mean(ga, "bound_ms"), library_ms=mean(ga, "library_ms"),
             f32_ms=mean(ga, "f32_ms"),
             u8_ms=mean([r for r in ga if "u8_int_ms" in r], "u8_int_ms"),
             f32_max_abs_err=max(r["f32_max_abs_err"] for r in ga),
             calls={m: h[m]["hist"] for m in h}, synthetic=wide["synthetic"],
             **dict(common, bound_by=ga[0]["bound_by"])),
        dict(name="compact_by_mask_u16",
             source="lightgbm_tpu_torch/csrc/compact.cu",
             core="lightgbm_tpu_torch/csrc/stable_partition.cuh",
             replaces="lightgbm_tpu/ops/compact.py:166",
             launches=L["compact_u16"], max_abs_err=0.0,
             ms=mean(comp, "ms"), plain_ms=mean(comp, "plain_ms"),
             bound_ms=mean(comp, "bound_ms"),
             library_ms=mean(comp, "library_ms"), u8_ms=mean(comp, "u8_ms"),
             shapes=comp, **common),
        dict(name="partition_move_u16",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             core="lightgbm_tpu_torch/csrc/stable_partition.cuh",
             replaces="lightgbm_tpu/ops/partition.py:129",
             launches=L["partition_u16"], max_abs_err=0.0,
             ms=mean(moves, "ms"), plain_ms=mean(moves, "plain_ms"),
             bound_ms=mean(moves, "bound_ms"),
             library_ms=mean(moves, "library_ms"),
             u8_ms=mean(moves, "u8_ms"), shapes=moves, **common)]


def main(argv):
    t_script = time.time()
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
        categorical_phase(lgt, th, tc, tp, serial, gbdt, smi,
                          criteo_data(lgt))
        return 0
    if "--only-efb" in argv:
        efb_phase(lgt, th, tc, tp, serial, gbdt, smi, criteo_data(lgt))
        return 0
    if "--only-ranking" in argv:
        ranking_phase(lgt, th, tc, tp, serial, gbdt, smi)
        return 0
    if "--only-bosch" in argv:
        bosch_phase(lgt, th, tc, tp, serial, gbdt, smi)
        return 0
    if "--only-ingest" in argv:
        ingest_phase(lgt, th, smi)
        print(f"whole script: {time.time() - t_script:.1f} s", flush=True)
        return 0
    if "--only-split-options" in argv:
        options_phase(lgt, th, tc, tp, serial, gbdt, smi)
        print(f"whole script: {time.time() - t_script:.1f} s", flush=True)
        return 0
    if "--only-wide-bins" in argv:
        wide_phase(lgt, th, tc, tp, serial, gbdt, smi, dev)
        print(f"whole script: {time.time() - t_script:.1f} s", flush=True)
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
    criteo = criteo_data(lgt)
    cat = categorical_phase(lgt, th, tc, tp, serial, gbdt, smi, criteo)
    efb = efb_phase(lgt, th, tc, tp, serial, gbdt, smi, criteo)
    del criteo
    rank = ranking_phase(lgt, th, tc, tp, serial, gbdt, smi)
    bosch = bosch_phase(lgt, th, tc, tp, serial, gbdt, smi)
    ingest = ingest_phase(lgt, th, smi)
    opts = options_phase(lgt, th, tc, tp, serial, gbdt, smi)
    wide = wide_phase(lgt, th, tc, tp, serial, gbdt, smi, dev)

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
                **{f"efb_{p}": efb["criteo"][p]["launches"][key]
                   for p in ["unbundled"] + list(CRITEO_PATHS)},
                "efb_card_vs_cpu": efb["card_vs_cpu"]["launches"][key],
                **{f"mslr_{p}": rank["mslr"][p]["launches"][key]
                   for p in list(MSLR_PATHS) + list(MSLR_SIDE)},
                "mslr_lengths": rank["lengths"]["launches"].get(key, 0),
                "ranking_card_vs_cpu": rank["card_vs_cpu"]["launches"][key],
                "bosch": bosch["bosch"]["launches"][key],
                "bosch_card_vs_cpu": bosch["card_vs_cpu"]["launches"][key],
                **({"ingest_10M": sum(r["kernel_a_launches"]
                                      for r in ingest["train"].values())}
                   if key == "histogram" else {}),
                **{f"split_options_{n}": r[n]["launches"][key]
                   for n, r in opts["runs"].items()},
                "split_options_card_vs_cpu":
                    opts["card_vs_cpu"]["launches"][key]}

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
             replay_mslr=rank["mslr"]["held_against_plain"]["replay"],
             held_efb=efb["criteo"]["held_against_plain"],
             held_bosch={k: v for k, v in bosch["bosch"][
                 "held_against_plain"].items()
                 if k != "compaction_times"}),
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
             shapes={k: v for k, v in comp.items()},
             held_bosch=bosch["bosch"]["held_against_plain"][
                 "compaction_times"]),
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
        *wide_entries(wide),
    ], "train": dict({k: v for k, v in train.items()
                      if k not in ("trees_leaves",)}, full_row=full,
                     partition_sweep=sweep, objectives=objs,
                     categorical=cat, efb=efb, ranking=rank, bosch=bosch,
                     ingest=ingest, split_options=opts,
                     wide_bins={k: v for k, v in wide.items()
                                if k != "held_against_plain"})}
    for v in (kernels_line["train"]["masked_it_per_s"],
              kernels_line["train"]["goss_it_per_s"]):
        if not math.isfinite(v):
            raise AssertionError("non-finite iteration rate")
    if json_out:
        with open(json_out, "w") as fh:
            json.dump(dict(kernels_line, replay=replay), fh, indent=1)
    print(f"whole script: {time.time() - t_script:.1f} s", flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
