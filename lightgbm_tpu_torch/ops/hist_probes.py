"""Histogram probe kernels: two variants of the multi-leaf histogram.

The port of the JAX package's two TPU probes of its histogram kernel,
``benchmarks/kernel_probe.py::hist1d`` (a row-block-only grid) and
``benchmarks/nibble_probe.py::hist_nibble`` (bins split as b = nb*u + v).
On the card each answers a design question about kernel A
(``csrc/histogram.cu``): the 1-D probe, a grid over row shares only, with
slot tiles for the lanes that rows carry and each row's leaf id and
values read once a pass for all the features of the pass, against
kernel A's re-reads per block of 1-2 features; the nibble probe, a
histogram held by a thread-block cluster in distributed shared memory.
No training path runs them.

Both compute ``multi_leaf_histogram`` in f32 mode: values rounded to bf16,
sums in f32, output ``[K, F, B, C]``. For CUDA tensors the wrappers launch
the hand-written kernels of ``csrc/hist_probes.cu`` (design notes there);
for CPU tensors they run ``multi_leaf_histogram_plain(int_mode=False)``.
They keep its rule for negative ids: a row with a negative leaf id
matches no lane, and a lane with a negative id gets a zero histogram.
The kernels take at most 32 lanes. The 1-D probe's kernel writes every
output element itself (one cooperative launch, partial histograms in a
per-stream scratch buffer, so the output is not zero-filled); its launch
raises where one feature's tiles of min(K, 32) lanes do not fit in shared
memory, and ``probe_1d_plan`` gives its passes. The nibble probe's
output is zero-filled and its kernel adds into it; its launch raises
when no cluster can be scheduled, and ``nibble_plan`` gives the launch
it picks.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .histogram import _check_inputs, _scratch, multi_leaf_histogram_plain

MAX_LANES = 32
NIBBLE_WIDTHS = (16, 32, 64)     # the TPU probe's nb values


def _check(bins_t, vals_t, leaf_id, small_ids, num_bins):
    _check_inputs(bins_t, vals_t, leaf_id, small_ids, num_bins)
    if bins_t.dtype != torch.uint8:
        # as their TPU kernels, the probes read byte bins only
        raise ValueError(f"the probe kernels take uint8 bins, got "
                         f"{bins_t.dtype}")
    if small_ids.shape[0] > MAX_LANES:
        raise ValueError(f"the probe kernels take at most {MAX_LANES} "
                         f"lanes, got {small_ids.shape[0]}")


def hist_probe_1d(bins_t: torch.Tensor, vals_t: torch.Tensor,
                  leaf_id: torch.Tensor, small_ids: torch.Tensor, *,
                  num_bins: int) -> torch.Tensor:
    """f32-mode multi-leaf histogram over a grid of row shares: slot
    tiles only for the lanes that rows carry, a block of features a pass
    (as many as fit with 32 replicas a tile, else as many as fit), each
    row's leaf id and values read once a pass for all of them.
    Arguments and result as ``multi_leaf_histogram`` (f32 mode);
    ``hist_probe_1d.launches`` counts kernel launches."""
    _check(bins_t, vals_t, leaf_id, small_ids, num_bins)
    dev = bins_t.device
    if dev.type == "cpu":
        return multi_leaf_histogram_plain(bins_t, vals_t, leaf_id, small_ids,
                                          num_bins=num_bins)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    F, n = bins_t.shape
    C = vals_t.shape[0]
    K = small_ids.shape[0]
    if n == 0 or F == 0 or K == 0:
        return torch.zeros((K, F, num_bins, C), dtype=torch.float32,
                           device=dev)
    out = torch.empty((K, F, num_bins, C), dtype=torch.float32, device=dev)
    lib = _lib()
    ptrs = (bins_t.data_ptr(), vals_t.data_ptr(), leaf_id.data_ptr())
    stream = torch.cuda.current_stream(dev)
    scratch = _scratch(stream, lib.lgbt_hist_probe_1d_scratch(
        *ptrs, n, F, C, K, num_bins))
    rc = lib.lgbt_hist_probe_1d(*ptrs, small_ids.data_ptr(), n, F, C, K,
                                num_bins, scratch.data_ptr(), out.data_ptr(),
                                stream.cuda_stream)
    kernels.check(rc, "hist_probe_1d")
    hist_probe_1d.launches += 1
    return out


hist_probe_1d.launches = 0

PROBE_1D_PLAN_FIELDS = ("tile_words", "tiles", "ctas", "smem_per_cta",
                        "features_per_pass", "replicas", "row_reads",
                        "ctas_with_rows", "blocks_per_share",
                        "units_per_share", "scratch_bytes")


def probe_1d_plan(bins_t: torch.Tensor, vals_t: torch.Tensor,
                  leaf_id: torch.Tensor, small_ids: torch.Tensor, *,
                  num_bins: int) -> dict:
    """The launch ``hist_probe_1d`` makes for these CUDA tensors, as a
    dict over ``PROBE_1D_PLAN_FIELDS``: the words of one slot tile and
    the tiles that fit, the CTAs and their shared memory, and for the
    live lanes (the distinct non-negative ids of ``small_ids`` that some
    row carries, found here on the device and read back, as the kernel
    finds them) the features per pass, the tile replicas, the times
    every row is read (feature blocks), the CTAs given rows, and the
    scratch the partial histograms take."""
    _check(bins_t, vals_t, leaf_id, small_ids, num_bins)
    if bins_t.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {bins_t.device}")
    F, n = bins_t.shape
    ids = torch.unique(small_ids[small_ids >= 0])
    live = int(torch.isin(ids, leaf_id).sum())
    plan = (ctypes.c_longlong * len(PROBE_1D_PLAN_FIELDS))()
    rc = _lib().lgbt_hist_probe_1d_plan(
        bins_t.data_ptr(), vals_t.data_ptr(), leaf_id.data_ptr(), n, F,
        vals_t.shape[0], small_ids.shape[0], num_bins, live, plan)
    kernels.check(rc, "hist_probe_1d_plan")
    return dict(zip(PROBE_1D_PLAN_FIELDS, plan))


def hist_probe_nibble(bins_t: torch.Tensor, vals_t: torch.Tensor,
                      leaf_id: torch.Tensor, small_ids: torch.Tensor, *,
                      num_bins: int, nb: int = 16) -> torch.Tensor:
    """f32-mode multi-leaf histogram over bin groups of ``nb``: a
    ``[K][nb][C]`` tile per (feature, bin group), a chunk of the tiles
    held by one thread-block cluster in its distributed shared memory.
    Arguments and result as ``multi_leaf_histogram`` (f32 mode);
    ``hist_probe_nibble.launches`` counts kernel launches."""
    _check(bins_t, vals_t, leaf_id, small_ids, num_bins)
    if nb < 1:
        raise ValueError(f"nb must be positive, got {nb}")
    dev = bins_t.device
    if dev.type == "cpu":
        return multi_leaf_histogram_plain(bins_t, vals_t, leaf_id, small_ids,
                                          num_bins=num_bins)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    F, n = bins_t.shape
    C = vals_t.shape[0]
    K = small_ids.shape[0]
    out = torch.zeros((K, F, num_bins, C), dtype=torch.float32, device=dev)
    rc = _lib().lgbt_hist_probe_nibble(
        bins_t.data_ptr(), vals_t.data_ptr(), leaf_id.data_ptr(),
        small_ids.data_ptr(), n, F, C, K, num_bins, nb, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "hist_probe_nibble")
    hist_probe_nibble.launches += 1
    return out


hist_probe_nibble.launches = 0

NIBBLE_PLAN_FIELDS = ("w", "groups", "cluster", "pairs_per_chunk",
                      "chunks", "clusters", "tiles_per_cta", "smem_per_cta",
                      "resident_clusters", "rows_per_cta",
                      "features_per_chunk")


def nibble_plan(bins_t: torch.Tensor, vals_t: torch.Tensor,
                leaf_id: torch.Tensor, small_ids: torch.Tensor, *,
                num_bins: int, nb: int = 16) -> dict:
    """The launch ``hist_probe_nibble`` picks for these CUDA tensors, as a
    dict over ``NIBBLE_PLAN_FIELDS``: the tile width w, the cluster size,
    the (feature, bin group) pairs per chunk (one pass over the rows
    each), the clusters launched and resident, and per CTA its tiles,
    shared memory and rows. ``CTAs = clusters x cluster``."""
    _check(bins_t, vals_t, leaf_id, small_ids, num_bins)
    if bins_t.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {bins_t.device}")
    F, n = bins_t.shape
    plan = (ctypes.c_int * len(NIBBLE_PLAN_FIELDS))()
    rc = _lib().lgbt_hist_probe_nibble_plan(
        n, F, vals_t.shape[0], small_ids.shape[0], num_bins, nb, plan)
    kernels.check(rc, "hist_probe_nibble_plan")
    return dict(zip(NIBBLE_PLAN_FIELDS, plan))


def _lib() -> ctypes.CDLL:
    lib = kernels.load("hist_probes")
    if lib.lgbt_hist_probe_1d.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, args, res in (
                ("lgbt_hist_probe_1d", [ptr] * 4 + [i32] * 5 + [ptr] * 3,
                 i32),
                ("lgbt_hist_probe_1d_scratch", [ptr] * 3 + [i32] * 5,
                 ctypes.c_longlong),
                ("lgbt_hist_probe_1d_plan", [ptr] * 3 + [i32] * 6
                 + [ctypes.POINTER(ctypes.c_longlong)], i32),
                ("lgbt_hist_probe_nibble", [ptr] * 4 + [i32] * 6 + [ptr] * 2,
                 i32),
                ("lgbt_hist_probe_nibble_plan",
                 [i32] * 6 + [ctypes.POINTER(i32)], i32)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
    return lib
