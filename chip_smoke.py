"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``lightgbm_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and then runs these phases:

1. kernel A (multi-leaf histogram) and kernel B (row compaction) against
   their plain torch versions at the training paths' shapes (kernel A
   also at the 2M-row run's padded rows and on one span round of its
   partition), timed;
2. the partition-move kernel at the 2M-row run's padded width (moved
   fractions 0.5 and 0.001), bit-equal to its plain version, timed;
3. the two histogram probe kernels at their probe shapes (the 1-D probe,
   and the nibble probe at nb = 16, 32, 64) within the f32 tolerance of
   the plain version and bit-equal to it on exact-sum inputs, timed
   beside kernel A in f32 mode;
4. the Higgs flagship (1M rows x 28 features, binary, 127 leaves, 255
   bins, GOSS with the compacted histogram buffer, quantized gradients)
   for 16 rounds through ``Booster.update``: holdout AUC and a model-text
   round trip;
5. full-row training (2M rows, no GOSS, bagging 0.8, feature_fraction
   0.8, quantized gradients) for 16 rounds, once with
   ``tpu_hist_partition=false`` and once with ``auto``: ``auto`` must
   engage the row partition and launch the move kernel every iteration,
   the two model texts must be byte-equal and the partition must scan
   fewer rows; then two more iterations of each under torch.profiler
   give the device's idle share.

Each training run sets the kernels' launch counts to 0 just before it
and reads them just after. The last two lines of standard output are the
per-kernel JSON line and the result line ``{"ok": true, "device":
{...}}``; any failure exits non-zero before the result line. It needs a
CUDA device and imports neither JAX nor ``lightgbm_tpu``.
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
# the span budget of the full-row run's span rounds: the largest S with
# 32 x S < the padded 2M rows (lightgbm_tpu_torch.ops.partition.span_budgets)
SPAN_BUDGET = 32_768
# full-row training: the flagship without GOSS, with bagging and
# feature_fraction; 2M rows pad to >= 2^20, where tpu_hist_partition=auto
# engages the leaf-ordered row partition
N_FULL = 2_000_000
FULL_PARAMS = {"objective": "binary", "num_leaves": 127, "max_bin": 255,
               "learning_rate": 0.1, "stochastic_rounding": True,
               "bagging_fraction": 0.8, "bagging_freq": 1,
               "feature_fraction": 0.8, "tpu_leaf_batch": 32,
               "tpu_hist_mode": "pool", "metric": "auc", "verbosity": -1,
               "device_type": "cuda"}
# the probes' shapes (benchmarks/kernel_probe.py:7-12 and
# benchmarks/nibble_probe.py:25-31): F, n, B, K, C
PROBE_SHAPES = {"hist_probe_1d": (28, 1_048_576, 256, 16, 3),
                "hist_probe_nibble": (28, 1_048_576, 256, 32, 3)}


def synth_higgs(n, f, seed=0):
    """Higgs-like data: the port's copy of bench.py::synth_higgs."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f)
    logit = (X @ w * 0.5 + 0.8 * X[:, 0] * X[:, 1]
             + 0.5 * np.abs(X[:, 2]) - 0.4)
    y = (logit + rng.normal(scale=1.0, size=n) > 0).astype(np.float64)
    return X.astype(np.float64), y


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
    repeated id), and the rows that match a lane: (idx, src, matched
    rows, row-lane pairs)."""
    F, C, K = bins.shape[0], vals.shape[0], ids.shape[0]
    dev = bins.device
    f_idx = torch.arange(F, device=dev)[:, None]
    c_idx = torch.arange(C, device=dev)
    idx, src = [], []
    for k in range(K):
        rows = torch.nonzero(leaf == ids[k]).flatten()
        cell = (k * F + f_idx) * B + bins[:, rows].long()          # [F, m]
        idx.append((cell[:, :, None] * C + c_idx).reshape(-1))
        src.append(vals[:, rows].T[None].expand(F, -1, C).reshape(-1))
    any_lane = (leaf[None, :] == ids[:, None]).any(0)
    pairs = sum(int(i.numel()) for i in idx) // (F * C)
    return torch.cat(idx), torch.cat(src), int(any_lane.sum()), pairs


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
    rows (the masked scan, and the partition's fallback scan), and one
    span round of the partitioned run (``span_case``)."""
    rng = np.random.default_rng(1)
    out = {}
    for label, n in (("masked", 1_003_520), ("goss", 311_296),
                     ("full_row", n_full_pad), ("spans", n_full_pad)):
        bins = torch.from_numpy(rng.integers(0, HIST_B, size=(HIST_F, n))
                                .astype(np.uint8)).to(dev)
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
        # buffer, its index computed before the timed call
        idx, src, m, pairs = lane_index(bins, vals["int"].to(torch.int32),
                                        leaf, ids, HIST_B)
        buf = torch.zeros(HIST_K * HIST_F * HIST_B * HIST_C,
                          dtype=torch.int32, device=dev)
        lib_ms = time_ms(lambda: buf.index_add_(0, idx, src), reps=5)
        del idx, src
        # the work this data needs: every leaf id, the bins and values of
        # the m rows that match a lane, the output once; an add per
        # row-lane match, feature and channel
        nbytes = (4 * n + (HIST_F + 4 * HIST_C) * m + 4 * HIST_K
                  + 4 * HIST_K * HIST_F * HIST_B * HIST_C)
        b_ms, b_by = bound(nbytes, pairs * HIST_F * HIST_C)
        out[label] = dict(n=n, matched_rows=m, row_lane_matches=pairs,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          **{f"{mode}_{k}": v for mode, r in res.items()
                             for k, v in r.items()})
        print(f"histogram {label} n={n} (rows matching a lane {m}, "
              f"row-lane matches {pairs}): int kernel "
              f"{res['int']['ms']:.4f} ms (plain {res['int']['plain_ms']:.2f}"
              f" ms, index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms); "
              f"f32 kernel {res['f32']['ms']:.4f} ms, max |diff| "
              f"{res['f32']['max_abs_err']:.3g}; exact-sum f32 bit-equal",
              flush=True)
    return out


def compaction_phase(dev, tc):
    """Kernel B at the GOSS keep fraction and one edge fraction."""
    n, F, C, R = 1_003_520, 28, 4, 1024
    rng = np.random.default_rng(2)
    bins = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                            .astype(np.uint8)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32)) \
        .to(dev)
    out = {}
    for label, frac in (("goss", 0.3), ("edge", 0.001)):
        mask = torch.from_numpy(rng.uniform(size=n) < frac).to(dev)
        k = int(mask.sum())
        out_cols = (311_296 if label == "goss"
                    else tc.compaction_out_cols(k, R, 4096))
        plan = tc.plan_compaction(mask, R, out_cols)
        args = (bins, vals, *plan)
        kw = dict(out_cols=out_cols, rows_per_block=R)
        gb, gv = tc.compact_rows(*args, **kw)
        pb, pv = tc.compact_rows_plain(*args, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(gb, pb) and torch.equal(
                gv.view(torch.int32), pv.view(torch.int32))):
            raise AssertionError(f"compaction {label}: kernel != plain")
        ms = time_ms(lambda: tc.compact_rows(*args, **kw))
        plain_ms = time_ms(lambda: tc.compact_rows_plain(*args, **kw),
                           reps=5)
        maskd = mask.clone()
        lib_ms = time_ms(lambda: (bins[:, maskd], vals[:, maskd]), reps=5)
        # every dest and block position, the k kept rows' columns, and
        # the whole output (its tail is zeros) once
        nbytes = (4 * n + 8 * (n // R) + (F + 4 * C) * k
                  + (F + 4 * C) * out_cols)
        b_ms, b_by = bound(nbytes, 0)
        out[label] = dict(n=n, kept=k, out_cols=out_cols, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
        print(f"compaction {label} keep={k}: kernel {ms:.4f} ms (plain "
              f"{plain_ms:.3f} ms, mask select {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms)", flush=True)
    return out


def partition_phase(dev, tp, n):
    """The partition-move kernel at the full-row run's padded width: the
    reference probe's worst moved fraction (0.5) and a sparse one."""
    F, C = HIST_F, HIST_C
    rng = np.random.default_rng(3)
    bins = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                            .astype(np.uint8)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32)) \
        .to(dev)
    leaf = torch.from_numpy(rng.integers(0, 127, size=n).astype(np.int32)) \
        .to(dev)
    out = tuple(torch.empty_like(a) for a in (bins, vals, leaf))
    res = {}
    for label, frac in (("half", 0.5), ("sparse", 0.001)):
        moved = torch.from_numpy(rng.uniform(size=n) < frac).to(dev)
        dest, _, _ = tp.plan_split_move(moved)
        args = (bins, vals, leaf, dest)
        kb, kv, kl = tp.move_cols(*args, out=out)
        pb, pv, pl = tp.move_rows_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(kb, pb) and torch.equal(kl, pl) and torch.equal(
                kv.view(torch.int32), pv.view(torch.int32))):
            raise AssertionError(f"partition move {label}: kernel != plain")
        ms = time_ms(lambda: tp.move_cols(*args, out=out))
        plain_ms = time_ms(lambda: tp.move_rows_plain(*args), reps=5)
        # library yardstick: one index_copy_ per array
        d64 = dest.long()
        lib_ms = time_ms(lambda: (out[0].index_copy_(1, d64, bins),
                                  out[1].index_copy_(1, d64, vals),
                                  out[2].index_copy_(0, d64, leaf)), reps=5)
        # every dest, every column read once and written once
        nbytes = 4 * n + 2 * (F + 4 * C + 4) * n
        b_ms, b_by = bound(nbytes, 0)
        res[label] = dict(n=n, moved=int(moved.sum()), ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
        print(f"partition move {label} n={n} moved={res[label]['moved']}: "
              f"kernel {ms:.4f} ms (plain {plain_ms:.3f} ms, index_copy_ "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms)", flush=True)
    return res


def probe_phase(dev, hp, th):
    """The two probe kernels at their probe shapes, each held against the
    plain version (within the f32 tolerance, and bit for bit on exact-sum
    inputs) and timed beside kernel A in f32 mode. The probes are on no
    training path: their launches count this phase's checked calls (two
    per shape, and per nb for the nibble probe)."""
    hp.hist_probe_1d.launches = hp.hist_probe_nibble.launches = 0
    res, launches = {}, {}
    for name, (F, n, B, K, C) in PROBE_SHAPES.items():
        rng = np.random.default_rng(4)
        bins = torch.from_numpy(rng.integers(0, 255, size=(F, n))
                                .astype(np.uint8)).to(dev)
        vals = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32)) \
            .to(dev)
        exact = exact_f32_vals(rng, C, n).to(dev)
        if name == "hist_probe_1d":
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
        for v, is_exact in ((vals, False), (exact, True)):
            ref = th.multi_leaf_histogram_plain(bins, v, leaf, ids,
                                                num_bins=B)
            for tag, fn in variants.items():
                got = fn(v)
                torch.cuda.synchronize()
                err = check_f32(f"{name} {tag}", got, ref, v, is_exact)
                if not is_exact:
                    r[tag]["max_abs_err"] = err
        launches[name] = getattr(hp, name).launches   # the checked calls
        for tag, fn in variants.items():
            r[tag]["ms"] = time_ms(lambda: fn(vals))
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
        res[name] = dict(F=F, n=n, B=B, K=K, C=C, matched_rows=m,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                         bound_by=b_by, variants=r)
        print(f"{name} F={F} n={n} B={B} K={K} C={C}: " + ", ".join(
            f"{t} {v['ms']:.4f} ms" for t, v in r.items())
            + f" (plain {plain_ms:.2f} ms, index_add_ {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms); exact-sum inputs bit-equal", flush=True)
    res["launches"] = launches
    return res


def trace_rounds(bst, rounds):
    """``rounds`` more iterations under ``torch.profiler``: wall and
    device-busy ms per iteration (the union of the device's kernel and
    copy intervals), the idle share, device-to-host copies per iteration
    (the host's blocking reads) and the kernels with the most device
    time. The profiler's own host overhead is in the wall time. Device
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
                    idle_share=None, dtoh_per_iter=None, top_kernels=None)
    busy_ms = busy_us / 1e3 / rounds
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        wall_ms_per_iter=wall_ms, busy_ms_per_iter=busy_ms,
        idle_share=1.0 - busy_ms / wall_ms,
        dtoh_per_iter=sum("DtoH" in e.name or "Device -> Host" in e.name
                          for e in dev_ev) / rounds,
        top_kernels=[(name[:80], us / 1e3 / rounds) for name, us in top])


def full_row_phase(lgt, th, tc, tp, n_pad):
    """Full-row training at 2M rows, the partition off and on (auto)."""
    X, y = synth_higgs(N_FULL + N_HOLDOUT, N_FEAT, seed=0)
    Xv, yv = X[N_FULL:], y[N_FULL:]
    t0 = time.time()
    ds = lgt.Dataset(X[:N_FULL], label=y[:N_FULL])
    vs = ds.create_valid(Xv, label=yv)
    runs = {}
    for mode in ("false", "auto"):
        bst = lgt.Booster(params=dict(FULL_PARAMS, tpu_hist_partition=mode),
                          train_set=ds)
        bst.add_valid(vs, "holdout")
        eng = bst.engine
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        if eng.data.n_pad != n_pad or eng.hist_partition != (mode == "auto"):
            raise AssertionError(f"full-row {mode}: n_pad {eng.data.n_pad}, "
                                 f"partition {eng.hist_partition}")
        if not eng.grow_cfg.int_hist:
            raise AssertionError("full-row run is not on quantized gradients")
        # this path: counts from 0 just before, read just after
        th.multi_leaf_histogram.launches = 0
        tc.compact_rows.launches = 0
        tp.move_cols.launches = 0
        per_iter, secs = [], []
        for _ in range(ROUNDS):
            m0 = tp.move_cols.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            per_iter.append(tp.move_cols.launches - m0)
        launches = {"histogram": th.multi_leaf_histogram.launches,
                    "compact": tc.compact_rows.launches,
                    "partition": tp.move_cols.launches}
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
              f"setup {setup_s:.2f} s", flush=True)
        # after the checked rounds: a traced pass for the idle share
        tr = runs[mode]["trace"] = trace_rounds(bst, TRACE_ROUNDS)
        print(f"full-row partition={mode} traced ({TRACE_ROUNDS} more "
              f"iterations): {tr['wall_ms_per_iter']:.2f} ms wall, "
              f"device busy {tr['busy_ms_per_iter']} ms, idle share "
              f"{tr['idle_share']}, device-to-host copies per iteration "
              f"{tr['dtoh_per_iter']}; top device time (ms per "
              f"iteration): {tr['top_kernels']}", flush=True)
        t0 = time.time()
    off, on = runs["false"], runs["auto"]
    if off["launches"]["histogram"] <= 0 or on["launches"]["histogram"] <= 0:
        raise AssertionError("full-row path skipped kernel A")
    if off["launches"]["partition"] != 0 or min(
            on["move_launches_per_iter"]) < 1:
        raise AssertionError(f"partition move launches per iteration: "
                             f"off {off['move_launches_per_iter']}, auto "
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


def train_phase(lgt, th, tc, tp):
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
    tc.compact_rows.launches = 0
    tp.move_cols.launches = 0
    per_iter, secs = [], []
    for _ in range(ROUNDS):
        h0, c0 = th.multi_leaf_histogram.launches, tc.compact_rows.launches
        goss = eng.goss_active()
        torch.cuda.synchronize()
        t = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        secs.append((goss, time.perf_counter() - t))
        per_iter.append((th.multi_leaf_histogram.launches - h0,
                         tc.compact_rows.launches - c0))
    launches = {"histogram": th.multi_leaf_histogram.launches,
                "compact": tc.compact_rows.launches,
                "partition": tp.move_cols.launches}
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
               first_iter_s=secs[0][1], per_iter_launches=per_iter,
               launches=launches, trees_leaves=[t.num_leaves
                                                for t in eng.models])
    print(f"train: {ROUNDS} rounds ({len(masked_s)} full-row, "
          f"{len(goss_s)} GOSS); holdout AUC {auc:.6f}; full-row "
          f"{res['masked_it_per_s']:.3f} it/s (first iteration "
          f"{secs[0][1]:.3f} s), GOSS {res['goss_it_per_s']:.3f} it/s; "
          f"model-text round trip max |diff| {rt:.3g}", flush=True)
    print(f"kernel launches per iteration (histogram, compaction): "
          f"{per_iter}", flush=True)
    return res


def main():
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
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    kernels.build()
    print(f"kernel build (nvcc, {len(kernels.KERNELS)} sources in "
          f"parallel): {time.time() - t0:.2f} s", flush=True)

    n_full_pad = pad_rows(N_FULL, Config({}).tpu_rows_per_block)
    hist = histogram_phase(dev, th, tp, n_full_pad)
    comp = compaction_phase(dev, tc)
    part = partition_phase(dev, tp, n_full_pad)
    probes = probe_phase(dev, hp, th)
    train = train_phase(lgt, th, tc, tp)
    full = full_row_phase(lgt, th, tc, tp, n_full_pad)

    h, c, p = hist["masked"], comp["goss"], part["half"]
    fl = {m: r["launches"] for m, r in full.items()}

    def path_launches(key):
        return {"goss_flagship": train["launches"][key],
                "full_row_masked": fl["false"][key],
                "full_row_partition": fl["auto"][key]}

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
                    variants=pr["variants"])

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
             shapes={k: v for k, v in hist.items()}),
        dict(name="compact_rows", route="cuda",
             source="lightgbm_tpu_torch/csrc/compact.cu",
             replaces="lightgbm_tpu/ops/compact.py:166",
             launches=train["launches"]["compact"],
             launches_by_path=path_launches("compact"),
             max_abs_err=c["max_abs_err"], ms=c["ms"],
             plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
             bound_by=c["bound_by"], library_ms=c["library_ms"],
             max_abs_diff=c["max_abs_err"], kernel_ms=c["ms"],
             shapes={k: v for k, v in comp.items()}),
        dict(name="partition_move", route="cuda",
             source="lightgbm_tpu_torch/csrc/partition.cu",
             replaces="lightgbm_tpu/ops/partition.py:129",
             launches=fl["auto"]["partition"],
             launches_by_path=path_launches("partition"),
             max_abs_err=p["max_abs_err"], ms=p["ms"],
             plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
             bound_by=p["bound_by"], library_ms=p["library_ms"],
             max_abs_diff=p["max_abs_err"], kernel_ms=p["ms"],
             shapes={k: v for k, v in part.items()}),
        probe_entry("hist_probe_1d", "probe",
                    "benchmarks/kernel_probe.py:43"),
        probe_entry("hist_probe_nibble", "nb16",
                    "benchmarks/nibble_probe.py:83"),
    ], "train": dict({k: v for k, v in train.items()
                      if k not in ("trees_leaves",)}, full_row=full)}
    for v in (kernels_line["train"]["masked_it_per_s"],
              kernels_line["train"]["goss_it_per_s"]):
        if not math.isfinite(v):
            raise AssertionError("non-finite iteration rate")
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
