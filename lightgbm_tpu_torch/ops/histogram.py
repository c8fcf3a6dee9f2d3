"""Multi-leaf histogram construction — the inner hot loop of GBDT training.

Reference: ``Bin::ConstructHistogram`` (src/io/dense_bin.hpp) and the CUDA
histogram kernel (src/treelearner/cuda/cuda_histogram_constructor.cu;
both UNVERIFIED — empty mount, see SURVEY.md banner): for every row in a
leaf, ``hist[bin] += (grad, hess, count)``.

The port of ``lightgbm_tpu/ops/pallas_histogram.py`` (the Pallas kernel
``multi_leaf_histogram``) and ``lightgbm_tpu/ops/histogram.py``: one scan
builds the histograms of K leaves at once,

    hist[k, f, b, c] = sum_r [bins_t[f, r] == b] * [leaf_id[r] == small_ids[k]]
                             * vals_t[c, r]

``multi_leaf_histogram`` launches the hand-written CUDA kernel
(``csrc/histogram.cu``) for CUDA tensors and runs the plain torch version
``multi_leaf_histogram_plain`` for CPU tensors. Two modes, as in the JAX
package: f32 mode rounds each value to bf16 and sums in f32 (sums depend
on the order, so kernel and plain agree to a tolerance); ``int_mode``
(quantized gradients) sums integer levels exactly in int32 and casts to
f32 (bit-equal in any order). Rows with a negative leaf id (the -1 rows
of ``partition.slice_spans`` windows) match no lane. Bin ids are uint8 (B
<= 256) or uint16 (wide bins, B <= 65,536); each dtype has its own
instance of the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .bins import BIN_DTYPES, MAX_BINS_U16, MAX_BINS_U8

MAX_CHANNELS = 8


def _check_inputs(bins_t, vals_t, leaf_id, small_ids, num_bins):
    if bins_t.dtype not in BIN_DTYPES or bins_t.dim() != 2:
        raise ValueError(f"bins_t must be [F, n] uint8 or uint16, got "
                         f"{tuple(bins_t.shape)} {bins_t.dtype}")
    F, n = bins_t.shape
    if vals_t.dtype != torch.float32 or vals_t.dim() != 2 \
            or vals_t.shape[1] != n:
        raise ValueError(f"vals_t must be [C, {n}] float32, got "
                         f"{tuple(vals_t.shape)} {vals_t.dtype}")
    if leaf_id.dtype != torch.int32 or tuple(leaf_id.shape) != (n,):
        raise ValueError(f"leaf_id must be [{n}] int32, got "
                         f"{tuple(leaf_id.shape)} {leaf_id.dtype}")
    if small_ids.dtype != torch.int32 or small_ids.dim() != 1:
        raise ValueError(f"small_ids must be [K] int32, got "
                         f"{tuple(small_ids.shape)} {small_ids.dtype}")
    max_bins = MAX_BINS_U8 if bins_t.dtype == torch.uint8 else MAX_BINS_U16
    if not 1 <= num_bins <= max_bins:
        raise ValueError(f"num_bins must be in 1..{max_bins} for "
                         f"{bins_t.dtype} bins, got {num_bins}")
    if not 1 <= vals_t.shape[0] <= MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} value channels, got "
                         f"{vals_t.shape[0]}")
    devs = {t.device for t in (bins_t, vals_t, leaf_id, small_ids)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if not all(t.is_contiguous()
               for t in (bins_t, vals_t, leaf_id, small_ids)):
        raise ValueError("histogram inputs must be contiguous")


def multi_leaf_histogram_plain(bins_t: torch.Tensor, vals_t: torch.Tensor,
                               leaf_id: torch.Tensor,
                               small_ids: torch.Tensor, *, num_bins: int,
                               int_mode: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel (same contract): one
    ``index_add_`` per lane over the lane's rows; rows with a negative
    leaf id take part in no lane."""
    F, n = bins_t.shape
    C = vals_t.shape[0]
    K = small_ids.shape[0]
    B = num_bins
    dev = bins_t.device
    if int_mode:
        vals = torch.round(vals_t).to(torch.int32)
    else:
        vals = vals_t.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((K, F * B, C), dtype=vals.dtype, device=dev)
    flat = (bins_t.to(torch.int64)
            + (torch.arange(F, device=dev, dtype=torch.int64) * B)[:, None])
    valid = leaf_id >= 0
    for k in range(K):
        sel = valid & (leaf_id == small_ids[k])
        idx = flat[:, sel].reshape(-1)                  # [F * m], f-major
        v = vals[:, sel].T                              # [m, C]
        out[k].index_add_(0, idx, v.repeat(F, 1))
    return out.to(torch.float32).reshape(K, F, B, C)


def multi_leaf_histogram(bins_t: torch.Tensor, vals_t: torch.Tensor,
                         leaf_id: torch.Tensor, small_ids: torch.Tensor, *,
                         num_bins: int, int_mode: bool = False
                         ) -> torch.Tensor:
    """Histograms of K leaves in one scan.

    Args:
      bins_t: ``[F, n]`` uint8 (``num_bins`` <= 256) or uint16 (<=
        65,536) feature-major binned matrix.
      vals_t: ``[C, n]`` float32 per-row values (grad*m, hess*m, count).
      leaf_id: ``[n]`` int32 current leaf of each row.
      small_ids: ``[K]`` int32 leaf ids to histogram. A row with a
        negative leaf id matches no lane, so a negative lane id (an
        inactive lane, -1) gives a zero histogram, as does an id that no
        row carries. (The reference documents this rule for -1 lanes; its
        ``lid == small`` compare also sums -1 rows into -1 lanes, which no
        caller reads.)
      num_bins: histogram width B (every bin id must be below it).
      int_mode: values are integer levels; sum them exactly.

    Returns:
      ``[K, F, B, C]`` float32, on the inputs' device. CPU tensors take
      ``multi_leaf_histogram_plain``; CUDA tensors launch the kernel, one
      launch that writes the f32 output itself
      (``multi_leaf_histogram.launches`` counts the launches, and
      ``multi_leaf_histogram.launches_u16`` those on uint16 bins).
    """
    _check_inputs(bins_t, vals_t, leaf_id, small_ids, num_bins)
    dev = bins_t.device
    if dev.type == "cpu":
        return multi_leaf_histogram_plain(bins_t, vals_t, leaf_id, small_ids,
                                          num_bins=num_bins,
                                          int_mode=int_mode)
    if dev.type != "cuda":
        raise ValueError(f"no histogram kernel for device {dev}")
    F, n = bins_t.shape
    C = vals_t.shape[0]
    K = small_ids.shape[0]
    if n == 0 or F == 0 or K == 0:
        return torch.zeros((K, F, num_bins, C), dtype=torch.float32,
                           device=dev)
    out = torch.empty((K, F, num_bins, C), dtype=torch.float32, device=dev)
    lib = _lib()
    wide = bins_t.dtype == torch.uint16
    query, fn = ((lib.lgbt_multi_leaf_histogram_u16_scratch,
                  lib.lgbt_multi_leaf_histogram_u16) if wide else
                 (lib.lgbt_multi_leaf_histogram_scratch,
                  lib.lgbt_multi_leaf_histogram))
    ptrs = (bins_t.data_ptr(), vals_t.data_ptr(), leaf_id.data_ptr())
    stream = torch.cuda.current_stream(dev)
    scratch = _scratch(stream, query(*ptrs, n, F, C, K, num_bins))
    rc = fn(*ptrs, small_ids.data_ptr(), n, F, C, K, num_bins, int(int_mode),
            scratch.data_ptr(), out.data_ptr(), stream.cuda_stream)
    kernels.check(rc, "multi_leaf_histogram")
    multi_leaf_histogram.launches += 1
    multi_leaf_histogram.launches_u16 += int(wide)
    return out


multi_leaf_histogram.launches = 0
multi_leaf_histogram.launches_u16 = 0

# the kernel's scratch (per-CTA partial histograms), one buffer per
# stream, grown as needed and kept: its contents never matter between
# calls, and calls on one stream run in order
_SCRATCH = {}


def _scratch(stream, nbytes: int) -> torch.Tensor:
    key = (stream.device, stream.cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                          device=stream.device)
        _SCRATCH[key] = buf
    return buf


def _lib() -> ctypes.CDLL:
    lib = kernels.load("histogram")
    if lib.lgbt_multi_leaf_histogram.argtypes is None:
        for fn in (lib.lgbt_multi_leaf_histogram,
                   lib.lgbt_multi_leaf_histogram_u16):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
        for q in (lib.lgbt_multi_leaf_histogram_scratch,
                  lib.lgbt_multi_leaf_histogram_u16_scratch):
            q.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            q.restype = ctypes.c_longlong
    return lib
