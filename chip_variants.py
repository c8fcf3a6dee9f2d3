"""Variants of the stable-partition kernels, timed on one NVIDIA GPU.

Run from the root of a checkout, after or beside ``chip_smoke.py``:

    python3 chip_variants.py

It builds copies of ``lightgbm_tpu_torch/csrc/partition.cu`` and
``compact.cu`` (both on ``stable_partition.cuh``) under the git-ignored
``build/variants/``, each with the core's text edited: other shapes of
the core (its constants ``kBufs``, stages in flight + 1; ``kStrips``,
columns a thread; ``kThreads``, threads a CTA) and stripped copies that
leave out one part of the data movement (the shared-memory reorder, the
global stores, the loads), whose outputs are wrong and only timed. Then
it times the move (``partition_move`` at the 2M-row run's padded width,
half moved) and
the compaction (``compact_by_mask`` at the GOSS flagship's shape) with
each library in turns (the committed kernel, the variants, then the same
in reverse), as device time, the real variants checked bit-equal to the
plain version first. One line per kernel, the card's name and power
limit first. It needs a CUDA device and imports neither JAX nor
``lightgbm_tpu``.

    python3 chip_variants.py --probe-extras [--parent REV]

needs neither a device nor nvcc: it writes the 1-D probe's variants,
copies of ``hist_probes.cu`` with its text edited, as
``build/hist_extra/probe1d_*.cu``, where ``chip_smoke.py`` builds them
and times each beside the 1-D probe in turns: the other design of the
adds (``k1dWarpTiles`` flipped), 1, 4, 8 or 16 replicas of each slot tile
in place of 32 (``k1dMinReplicas``: more features a pass, fewer reads of
the rows, more bank conflicts; 1 reads each row once for all features
at one live lane), bins of 2 or 8 features loaded together in place of
4, and stripped copies whose outputs are wrong and only timed (int32
adds in place of the f32 ones, also at 1 replica; no adds, no
reduction, neither; no adds and neither at 1 replica). With ``--parent
REV`` (in a git checkout) it also writes REV's ``hist_probes.cu`` as
``probe1d_parent.cu``.
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "lightgbm_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "variants")
BUFS = "constexpr int kBufs = 2;"
STRIPS = "constexpr int kStrips = 16;"
THREADS = "constexpr int kThreads = 256;"
# name -> [(text of stable_partition.cuh, replacement)]: the shapes ...
SHAPES = {
    "bufs3": [(BUFS, "constexpr int kBufs = 3;")],
    "strips8": [(STRIPS, "constexpr int kStrips = 8;")],
    "strips32": [(STRIPS, "constexpr int kStrips = 32;")],
    "threads512": [(THREADS, "constexpr int kThreads = 512;")],
    "threads128_strips32": [(THREADS, "constexpr int kThreads = 128;"),
                            (STRIPS, "constexpr int kStrips = 32;")],
}
# ... and the stripped copies
STRIPPED = {
    "no_reorder": ("    Layout L) {\n#pragma unroll\n  for (int k = 0; "
                   "k < kStrips; ++k) {\n",
                   "    Layout L) {\n  return;\n#pragma unroll\n  for (int "
                   "k = 0; k < kStrips; ++k) {\n"),
    "no_store": ("  const int V = 16 / es;\n  const int nfc = nfe > 0",
                 "  return;\n  const int V = 16 / es;\n  const int nfc = "
                 "nfe > 0"),
    "no_load": ("  for (int c = threadIdx.x; c < full; c += kThreads)\n"
                "    cp_async16(dst + 16 * c, src + 16 * c);\n"
                "  for (int b = 16 * full + threadIdx.x; b < bytes; "
                "b += kThreads)\n    dst[b] = src[b];\n", ""),
}
EDITS = dict(SHAPES, **{tag: [edit] for tag, edit in STRIPPED.items()})
# the 1-D probe's edits of hist_probes.cu: the other design of its adds,
# and the stripped copies (an add never taken keeps the loads and slot
# lookups)
WARP_TILES = ("constexpr bool k1dWarpTiles = false;",
              "constexpr bool k1dWarpTiles = true;")
PROBE_1D_INT32 = ("  for (int c = 0; c < kC; ++c) atomicAdd(cell + c * R, v[c]);",
                  "  for (int c = 0; c < kC; ++c) atomicAdd(reinterpret_cast"
                  "<int*>(cell + c * R), __float_as_int(v[c]));")
PROBE_1D_NO_ADDS = [("  if (s < 0 || b >= B) return;\n  float* cell",
                     "  if (s < 0 || b >= B || __float_as_int(v[0]) != "
                     "0x7f7f7f7f) return;\n  float* cell"),
                    ("              add_warp<kC>(tl, hit, b, v, lane);",
                     "              if (__float_as_int(v[0]) == 0x7f7f7f7f)"
                     " add_warp<kC>(tl, hit, b, v, lane);")]
PHASE_2 = ("  // ---- phase 2: partials -> output rows (k, f), in CTA order "
           "----------\n  cg::this_grid().sync();\n")
PROBE_1D_NO_REDUCE = (PHASE_2, PHASE_2 + "  return;\n")
ENTRIES = {"partition": ("lgbt_partition_move",
                         "lgbt_partition_scratch_bytes"),
           "compact": ("lgbt_compact_by_mask", "lgbt_compact_scratch_bytes")}


def build_all(kernels):
    """One nvcc per (variant, source), all at once; {(name, variant):
    CDLL}."""
    core = open(os.path.join(SRC, "stable_partition.cuh")).read()
    jobs = {}
    for tag, edits in EDITS.items():
        d = os.path.join(OUT, tag)
        os.makedirs(d, exist_ok=True)
        text = core
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{tag}: anchor not found once in "
                                   "stable_partition.cuh")
            text = text.replace(old, new)
        with open(os.path.join(d, "stable_partition.cuh"), "w") as fh:
            fh.write(text)
        for name in ENTRIES:
            with open(os.path.join(SRC, f"{name}.cu")) as src, \
                    open(os.path.join(d, f"{name}.cu"), "w") as dst:
                dst.write(src.read())
            so = os.path.join(d, f"lib{name}.so")
            jobs[(name, tag)] = (subprocess.Popen(
                [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so,
                 os.path.join(d, f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{text}")
        libs[key] = ctypes.CDLL(so)
    return libs


def bound_lib(mod, name, lib):
    """``lib`` with the C entries typed like the committed library's, as a
    stand-in for ``mod._lib``."""
    real = mod._lib()
    for fname in ENTRIES[name]:
        fn, ref = getattr(lib, fname), getattr(real, fname)
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return lambda: lib


def write_probe_extras(parent=None):
    """Write the 1-D probe's variant and stripped copies (and REV's
    ``hist_probes.cu``, for ``parent=REV``) under ``build/hist_extra/``;
    returns the paths."""
    with open(os.path.join(SRC, "hist_probes.cu")) as fh:
        src = fh.read()
    reps = "constexpr int k1dMinReplicas = {};"
    rows_once = (reps.format(32), reps.format(1))
    batch = "constexpr int k1dBinBatch = {};"
    edits = {"probe1d_warp_tiles": [WARP_TILES],
             **{f"probe1d_replicas{r}": [(reps.format(32), reps.format(r))]
                for r in (1, 4, 8, 16)},
             **{f"probe1d_binbatch{b}": [(batch.format(4), batch.format(b))]
                for b in (2, 8)},
             "probe1d_int32": [PROBE_1D_INT32],
             "probe1d_replicas1_int32": [rows_once, PROBE_1D_INT32],
             "probe1d_no_adds": PROBE_1D_NO_ADDS,
             "probe1d_no_reduce": [PROBE_1D_NO_REDUCE],
             "probe1d_no_adds_no_reduce": PROBE_1D_NO_ADDS
             + [PROBE_1D_NO_REDUCE],
             "probe1d_replicas1_no_adds": [rows_once] + PROBE_1D_NO_ADDS,
             "probe1d_replicas1_no_adds_no_reduce": [rows_once]
             + PROBE_1D_NO_ADDS + [PROBE_1D_NO_REDUCE]}
    out_dir = os.path.join(ROOT, "build", "hist_extra")
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for tag, tag_edits in edits.items():
        text = src
        for old, new in tag_edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{tag}: anchor not found once in "
                                   f"hist_probes.cu: {old!r}")
            text = text.replace(old, new)
        texts[tag] = text
    if parent:
        texts["probe1d_parent"] = subprocess.run(
            ["git", "show", f"{parent}:lightgbm_tpu_torch/csrc/"
             "hist_probes.cu"], cwd=ROOT, capture_output=True, text=True,
            check=True).stdout
    paths = []
    for tag, text in texts.items():
        paths.append(os.path.join(out_dir, f"{tag}.cu"))
        with open(paths[-1], "w") as fh:
            fh.write(text)
    return paths


def main():
    if "--probe-extras" in sys.argv:
        parent = (sys.argv[sys.argv.index("--parent") + 1]
                  if "--parent" in sys.argv else None)
        for path in write_probe_extras(parent):
            print(path)
        return 0
    if not torch.cuda.is_available():
        print("chip_variants.py: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0],
          flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from lightgbm_tpu_torch.ops import compact as tc
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import partition as tp
    kernels.build(["compact", "partition"])
    libs = build_all(kernels)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(6)
    n, n2, F, out_cols = 2_002_944, 1_003_520, 28, 311_296
    bins = torch.from_numpy(rng.integers(0, 256, size=(F, n))
                            .astype(np.uint8)).to(dev)
    vals = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)) \
        .to(dev)
    old, new = cs.move_case(rng, n, 0.5, dev)
    out = tuple(torch.empty_like(a) for a in (bins, vals, new))
    b2 = bins[:, :n2].contiguous()
    v4 = torch.from_numpy(rng.normal(size=(4, n2)).astype(np.float32)) \
        .to(dev)
    keep = torch.from_numpy(rng.uniform(size=n2) < 0.3).to(dev)
    pmove = tp.partition_move_plain(bins, vals, old, new)
    pcomp = tc.compact_by_mask_plain(b2, v4, keep, out_cols)
    cases = {
        "partition": (tp, lambda: tp.partition_move(bins, vals, old, new,
                                                    out=out),
                      lambda r: all(cs.same_bits(a, b) for a, b in
                                    zip(r[0] + (r[2],),
                                        pmove[0] + (pmove[2],)))),
        "compact": (tc, lambda: tc.compact_by_mask(b2, v4, keep, out_cols),
                    lambda r: all(cs.same_bits(a, b)
                                  for a, b in zip(r, pcomp))),
    }
    for name, (mod, call, check) in cases.items():
        real = mod._lib
        fns = {"committed": real}
        fns.update({tag: bound_lib(mod, name, libs[(name, tag)])
                    for tag in EDITS})
        times = {x: [] for x in fns}
        try:
            for x in list(fns) + list(fns)[::-1]:
                mod._lib = fns[x]
                got = call()
                torch.cuda.synchronize()
                if x not in STRIPPED and not check(got):
                    raise AssertionError(f"{name} {x}: differs from the "
                                         "plain version")
                times[x].append(cs.device_ms(call))
        finally:
            mod._lib = real
        grid = {}
        for x in fns:
            lib = (real() if x == "committed" else libs[(name, x)])
            g = getattr(lib, f"lgbt_{name}_grid")
            g.argtypes, g.restype = [ctypes.c_int], ctypes.c_int
            grid[x] = g(n if name == "partition" else n2)
        print(f"{name} device ms in turns (committed, variants, reversed; "
              f"shapes and the committed kernel bit-equal to the plain "
              f"version, stripped copies timed only): " + ", ".join(
                  f"{x} {sum(t) / len(t):.4f} {[round(v, 4) for v in t]} "
                  f"(grid {grid[x]})" for x, t in times.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
