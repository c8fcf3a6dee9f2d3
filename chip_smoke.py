"""Smoke run of lightgbm_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``lightgbm_tpu_torch/csrc``,
holds each against its plain torch version at the training path's shapes
and times it, then trains the Higgs flagship (1M rows x 28 features,
binary, 127 leaves, 255 bins, GOSS with the compacted histogram buffer,
quantized gradients) for 16 rounds through ``lightgbm_tpu_torch.train``
and checks holdout AUC and a model-text round trip. The last two lines of
standard output are the per-kernel JSON line and the result line
``{"ok": true, "device": {...}}``; any failure exits non-zero before the
result line. It needs a CUDA device and imports neither JAX nor
``lightgbm_tpu``.
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
PARAMS = {"objective": "binary", "num_leaves": 127, "max_bin": 255,
          "learning_rate": 0.1, "use_quantized_grad": True,
          "stochastic_rounding": True, "data_sample_strategy": "goss",
          "tpu_leaf_batch": 32, "tpu_hist_mode": "pool",
          "tpu_goss_compact": True, "metric": "auc", "verbosity": -1,
          "device_type": "cuda"}
# main-path histogram shapes: padded rows of the masked iterations and the
# GOSS buffer (lightgbm_tpu_torch.boosting.gbdt: n_pad and goss_n_sub)
HIST_F, HIST_B, HIST_K, HIST_C = 28, 256, 32, 3


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


def histogram_phase(dev, th):
    """Kernel A at the main path's two shapes, int and f32 mode."""
    rng = np.random.default_rng(1)
    out = {}
    for label, n in (("masked", 1_003_520), ("goss", 311_296)):
        bins = torch.from_numpy(rng.integers(0, HIST_B, size=(HIST_F, n))
                                .astype(np.uint8)).to(dev)
        levels = np.stack([rng.integers(-2, 3, size=n),
                           rng.integers(0, 4, size=n),
                           (rng.random(n) < 0.9)]).astype(np.float32)
        vals_int = torch.from_numpy(levels).to(dev)
        vals_f32 = torch.from_numpy(
            rng.normal(size=(HIST_C, n)).astype(np.float32)).to(dev)
        leaf = torch.from_numpy(rng.integers(0, 2 * HIST_K, size=n)
                                .astype(np.int32)).to(dev)
        ids = np.arange(HIST_K, dtype=np.int32) * 2
        ids[[5, 17, 30]] = -1                      # inactive lanes
        ids = torch.from_numpy(ids).to(dev)
        res = {}
        for mode, vals in (("int", vals_int), ("f32", vals_f32)):
            args = (bins, vals, leaf, ids)
            kw = dict(num_bins=HIST_B, int_mode=mode == "int")
            got = th.multi_leaf_histogram(*args, **kw)
            ref = th.multi_leaf_histogram_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if mode == "int":
                if not torch.equal(got, ref):
                    raise AssertionError(f"histogram int mode {label}: "
                                         f"max |diff| {err}")
            else:
                # same bf16 operands, f32 sums in another order
                vb = vals.to(torch.bfloat16).float().abs().sum(1)
                tol = 2.0 ** -20 * vb
                if not bool(((got - ref).abs()
                             <= tol[None, None, None, :]).all()):
                    raise AssertionError(f"histogram f32 mode {label}: "
                                         f"max |diff| {err}")
            res[mode] = dict(max_abs_err=err,
                             ms=time_ms(lambda: th.multi_leaf_histogram(
                                 *args, **kw)),
                             plain_ms=time_ms(lambda: th.
                                              multi_leaf_histogram_plain(
                                                  *args, **kw), reps=3,
                                              warmup=1))
        # library yardstick: one index_add_ into the flat [K*F*B*C]
        # buffer, its index computed before the timed call
        lane = torch.full((2 * HIST_K + 1,), -1, dtype=torch.int64,
                          device=dev)
        valid = ids >= 0
        lane[ids[valid].long()] = torch.arange(HIST_K, device=dev)[valid]
        row_lane = lane[leaf.long()]
        sel = row_lane >= 0
        m = int(sel.sum())
        f_idx = torch.arange(HIST_F, device=dev)[:, None]
        cell = ((row_lane[sel][None, :] * HIST_F + f_idx) * HIST_B
                + bins[:, sel].long())                      # [F, m]
        idx = (cell[:, :, None] * HIST_C
               + torch.arange(HIST_C, device=dev)).reshape(-1)
        src = vals_int[:, sel].T[None].expand(HIST_F, m, HIST_C) \
            .reshape(-1).to(torch.int32).contiguous()
        buf = torch.zeros(HIST_K * HIST_F * HIST_B * HIST_C,
                          dtype=torch.int32, device=dev)
        lib_ms = time_ms(lambda: buf.index_add_(0, idx, src), reps=5)
        # the work this data needs: every leaf id, the bins and values of
        # the m rows that match a lane, the output once
        nbytes = (4 * n + (HIST_F + 4 * HIST_C) * m + 4 * HIST_K
                  + 4 * HIST_K * HIST_F * HIST_B * HIST_C)
        b_ms, b_by = bound(nbytes, m * HIST_F * HIST_C)
        out[label] = dict(n=n, matched_rows=m, bound_ms=b_ms, bound_by=b_by,
                          library_ms=lib_ms, **{
                              f"{mode}_{k}": v for mode, r in res.items()
                              for k, v in r.items()})
        print(f"histogram {label} n={n}: int kernel "
              f"{res['int']['ms']:.4f} ms (plain {res['int']['plain_ms']:.2f}"
              f" ms, index_add_ {lib_ms:.4f} ms, bound {b_ms:.4f} ms); "
              f"f32 kernel {res['f32']['ms']:.4f} ms, max |diff| "
              f"{res['f32']['max_abs_err']:.3g}", flush=True)
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


def train_phase(lgt, th, tc):
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
                "compact": tc.compact_rows.launches}
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
    from lightgbm_tpu_torch.ops import compact as tc
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.time()
    kernels.build()
    print(f"kernel build (nvcc, {len(kernels.KERNELS)} sources in "
          f"parallel): {time.time() - t0:.2f} s", flush=True)

    hist = histogram_phase(dev, th)
    comp = compaction_phase(dev, tc)
    train = train_phase(lgt, th, tc)

    h, c = hist["masked"], comp["goss"]
    kernels_line = {"kernels": [
        dict(name="multi_leaf_histogram", route="cuda",
             source="lightgbm_tpu_torch/csrc/histogram.cu",
             replaces="lightgbm_tpu/ops/pallas_histogram.py:80",
             launches=train["launches"]["histogram"],
             max_abs_err=h["int_max_abs_err"], ms=h["int_ms"],
             plain_ms=h["int_plain_ms"], bound_ms=h["bound_ms"],
             bound_by=h["bound_by"], library_ms=h["library_ms"],
             max_abs_diff=h["int_max_abs_err"], kernel_ms=h["int_ms"],
             shapes={k: v for k, v in hist.items()}),
        dict(name="compact_rows", route="cuda",
             source="lightgbm_tpu_torch/csrc/compact.cu",
             replaces="lightgbm_tpu/ops/compact.py:166",
             launches=train["launches"]["compact"],
             max_abs_err=c["max_abs_err"], ms=c["ms"],
             plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
             bound_by=c["bound_by"], library_ms=c["library_ms"],
             max_abs_diff=c["max_abs_err"], kernel_ms=c["ms"],
             shapes={k: v for k, v in comp.items()}),
    ], "train": {k: v for k, v in train.items()
                 if k not in ("trees_leaves",)}}
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
