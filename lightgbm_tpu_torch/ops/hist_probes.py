"""Histogram probe kernels: two variants of the multi-leaf histogram.

The port of the JAX package's two TPU probes of its histogram kernel,
``benchmarks/kernel_probe.py::hist1d`` (a row-block-only grid) and
``benchmarks/nibble_probe.py::hist_nibble`` (bins split as b = nb*u + v).
On the card each answers a design question about kernel A
(``csrc/histogram.cu``): the 1-D probe, rows read once per CTA for all
features; the nibble probe, a histogram held by a thread-block cluster in
distributed shared memory, with adds routed to the CTA that owns a
(feature, bin group) tile. No training path runs them.

Both compute ``multi_leaf_histogram`` in f32 mode: values rounded to bf16,
sums in f32, output ``[K, F, B, C]``. For CUDA tensors the wrappers launch
the hand-written kernels of ``csrc/hist_probes.cu`` (design notes there);
for CPU tensors they run ``multi_leaf_histogram_plain(int_mode=False)``.
They keep its rule for negative ids: a row with a negative leaf id
matches no lane, and a lane with a negative id gets a zero histogram.
The kernels take at most 32 lanes; the 1-D probe also needs one
feature's ``[K][B][C]`` f32 tile to fit in shared memory, and its launch
raises where it does not. The nibble probe's launch raises when no
cluster can be scheduled; ``nibble_plan`` gives the launch it picks.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .histogram import _check_inputs, multi_leaf_histogram_plain

MAX_LANES = 32
NIBBLE_WIDTHS = (16, 32, 64)     # the TPU probe's nb values


def _check(bins_t, vals_t, leaf_id, small_ids, num_bins):
    _check_inputs(bins_t, vals_t, leaf_id, small_ids, num_bins)
    if small_ids.shape[0] > MAX_LANES:
        raise ValueError(f"the probe kernels take at most {MAX_LANES} "
                         f"lanes, got {small_ids.shape[0]}")


def _launch(name: str, extra_args, bins_t, vals_t, leaf_id, small_ids,
            num_bins):
    dev = bins_t.device
    F, n = bins_t.shape
    C = vals_t.shape[0]
    K = small_ids.shape[0]
    out = torch.zeros((K, F, num_bins, C), dtype=torch.float32, device=dev)
    rc = getattr(_lib(), f"lgbt_{name}")(
        bins_t.data_ptr(), vals_t.data_ptr(), leaf_id.data_ptr(),
        small_ids.data_ptr(), n, F, C, K, num_bins, *extra_args,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, name)
    return out


def hist_probe_1d(bins_t: torch.Tensor, vals_t: torch.Tensor,
                  leaf_id: torch.Tensor, small_ids: torch.Tensor, *,
                  num_bins: int) -> torch.Tensor:
    """f32-mode multi-leaf histogram, row-chunk grid: each CTA reads its
    rows' leaf ids and values once and loops over feature tiles.
    Arguments and result as ``multi_leaf_histogram`` (f32 mode);
    ``hist_probe_1d.launches`` counts kernel launches."""
    _check(bins_t, vals_t, leaf_id, small_ids, num_bins)
    dev = bins_t.device
    if dev.type == "cpu":
        return multi_leaf_histogram_plain(bins_t, vals_t, leaf_id, small_ids,
                                          num_bins=num_bins)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    out = _launch("hist_probe_1d", (), bins_t, vals_t, leaf_id, small_ids,
                  num_bins)
    hist_probe_1d.launches += 1
    return out


hist_probe_1d.launches = 0


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
    out = _launch("hist_probe_nibble", (nb,), bins_t, vals_t, leaf_id,
                  small_ids, num_bins)
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
    for name, n_int in (("lgbt_hist_probe_1d", 5),
                        ("lgbt_hist_probe_nibble", 6)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p] * 2)
            fn.restype = ctypes.c_int
    fn = lib.lgbt_hist_probe_nibble_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return lib
