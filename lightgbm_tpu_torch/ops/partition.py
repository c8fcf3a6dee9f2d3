"""Leaf-ordered row partition (tpu_hist_partition).

Reference: ``CUDADataPartition`` (src/treelearner/cuda/cuda_data_partition
.cu, UNVERIFIED — empty mount, see SURVEY.md banner): each leaf's rows are
kept CONTIGUOUS, so the smaller child's histogram scans only that child's
rows and the sibling comes free by subtraction.

The port of ``lightgbm_tpu/ops/partition.py``:

- the histogram source (bins, values and a per-POSITION leaf id) is kept
  reordered so every leaf occupies one span, described by per-leaf
  ``(offset, count)`` tables;
- after each split batch the rows whose leaf id changed (they routed to a
  right child) move stably to the back and every other row stably to the
  front, in one call: ``partition_move`` compares the old and new leaf
  ids, moves the columns and returns the moved-prefix sums ``cum`` and
  the front size, from which the tables update at the few leaf
  boundaries (``update_tables``);
- each round histograms only the elected children's spans, cut to a
  power-of-two budget from ``span_budgets`` by ``slice_spans``; positions
  of a neighbouring leaf inside a span get leaf id -1.

For CUDA tensors ``partition_move`` is one launch of the hand-written
kernel (``csrc/partition.cu`` on the stable-partition core of
``csrc/stable_partition.cuh``), which computes the destinations itself;
for CPU tensors it runs ``partition_move_plain``, the composition of the
JAX package's plan (``plan_split_move``) and an indexed copy
(``move_rows_plain``). It writes the full inclusive ``cum`` (4 B a
column) rather than only the O(#leaves) prefixes the tables read: that
keeps ``update_tables`` the JAX package's function, and those prefixes'
positions would be one more list to build before every launch. The
reference's TPU form (``move_cols_tpu``) needs two compaction passes, a
roll and a blend, and carries the leaf ids as an extra float32 channel
through its bf16x3 split; a GPU store to a computed address is exact, so
here the int32 ids move as their own array.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels
from .bins import BIN_DTYPES, movable

i32 = torch.int32
Arrays = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def plan_split_move(moved: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable front/back destinations for one split batch.

    Args:
      moved: ``[n]`` bool — True for rows that route to a RIGHT child
        this round (their leaf id changed).

    Returns:
      (dest ``[n]`` int32 destination positions — a permutation,
      n_front int32 scalar — first back-region position,
      cum ``[n]`` int32 — inclusive prefix counts of ``moved``).
    """
    n = moved.shape[0]
    mi = moved.to(i32)
    cum = torch.cumsum(mi, 0, dtype=i32)
    exc = cum - mi                       # moved rows strictly before i
    n_front = n - cum[-1]
    iota = torch.arange(n, dtype=i32, device=moved.device)
    dest = torch.where(moved, n_front + exc, iota - exc)
    return dest, n_front, cum


def prefix_at(cum: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``# moved rows strictly before position pos`` for positions in
    ``[0, n]`` (a gather of O(#leaves) entries)."""
    p = pos.clamp(0, cum.shape[0]).to(torch.int64)
    return torch.where(p > 0, cum[(p - 1).clamp(min=0)], 0)


def update_tables(off: torch.Tensor, cnt: torch.Tensor, cum: torch.Tensor,
                  n_front: torch.Tensor, parents: torch.Tensor,
                  new_ids: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New per-leaf (offset, count) tables after a split batch's move.

    Every leaf that is not a right child (untouched leaves, and left
    children, which keep the parent's slot) shifts left by the moved rows
    before its old offset; right children land in the back region in
    parent-position order.

    Args:
      off / cnt: ``[L+1]`` int32 old tables (slot L = trash).
      cum / n_front: inclusive moved-prefix and front size, from
        ``partition_move`` (or ``plan_split_move``).
      parents: ``[K]`` split leaf slots (trash slot for invalid lanes).
      new_ids: ``[K]`` right-child slots (trash slot for invalid lanes).
      valid: ``[K]`` bool lane validity.
    """
    parents = parents.to(torch.int64)
    new_ids = new_ids.to(torch.int64)
    new_off = off - prefix_at(cum, off)
    s_par = prefix_at(cum, off[parents])
    e_par = prefix_at(cum, off[parents] + cnt[parents])
    n_right = torch.where(valid, e_par - s_par, 0).to(i32)
    # invalid lanes all name the trash slot and write equal values there
    new_off[new_ids] = (n_front + s_par).to(i32)
    new_cnt = cnt.index_add(0, parents, -n_right)
    new_cnt[new_ids] = n_right
    return new_off, new_cnt


def move_rows_plain(bins_t: torch.Tensor, vals_t: torch.Tensor,
                    leaf: torch.Tensor, dest: torch.Tensor,
                    out: Optional[Arrays] = None) -> Arrays:
    """An exact computed-index scatter ``out[..., dest[r]] = in[..., r]``
    (uint16 bins through their int16 view)."""
    ob, ov, ol = out if out is not None else _empty_like(bins_t, vals_t,
                                                         leaf)
    d = dest.to(torch.int64)
    movable(ob)[:, d] = movable(bins_t)
    ov[:, d] = vals_t
    ol[d] = leaf
    return ob, ov, ol


def partition_move_plain(bins_t: torch.Tensor, vals_t: torch.Tensor,
                         leaf_old: torch.Tensor, leaf_new: torch.Tensor,
                         out: Optional[Arrays] = None
                         ) -> Tuple[Arrays, torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel (same contract):
    ``plan_split_move(leaf_new != leaf_old)`` then ``move_rows_plain``."""
    dest, n_front, cum = plan_split_move(leaf_new != leaf_old)
    return move_rows_plain(bins_t, vals_t, leaf_new, dest, out), n_front, cum


def _empty_like(bins_t, vals_t, leaf) -> Arrays:
    return (torch.empty_like(bins_t), torch.empty_like(vals_t),
            torch.empty_like(leaf))


def _check_inputs(bins_t, vals_t, leaf_old, leaf_new, out):
    if bins_t.dtype not in BIN_DTYPES or bins_t.dim() != 2:
        raise ValueError(f"bins_t must be [F, n] uint8 or uint16, got "
                         f"{tuple(bins_t.shape)} {bins_t.dtype}")
    n = bins_t.shape[1]
    if n < 1:
        raise ValueError("partition_move needs at least one column")
    if vals_t.dtype != torch.float32 or vals_t.dim() != 2 \
            or vals_t.shape[1] != n:
        raise ValueError(f"vals_t must be [C, {n}] float32, got "
                         f"{tuple(vals_t.shape)} {vals_t.dtype}")
    for name, t in (("leaf_old", leaf_old), ("leaf_new", leaf_new)):
        if t.dtype != i32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [bins_t, vals_t, leaf_old, leaf_new]
    if out is not None:
        for src, o in zip((bins_t, vals_t, leaf_new), out):
            if o.dtype != src.dtype or o.shape != src.shape:
                raise ValueError(f"out buffer {tuple(o.shape)} {o.dtype} "
                                 f"does not match its input "
                                 f"{tuple(src.shape)} {src.dtype}")
            if o.data_ptr() == src.data_ptr():
                raise ValueError("partition_move never works in place: "
                                 "pass a second buffer")
        tensors += list(out)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("partition_move inputs must be contiguous")


def partition_move(bins_t: torch.Tensor, vals_t: torch.Tensor,
                   leaf_old: torch.Tensor, leaf_new: torch.Tensor,
                   out: Optional[Arrays] = None
                   ) -> Tuple[Arrays, torch.Tensor, torch.Tensor]:
    """One split batch's stable front/back move of the partitioned source.

    Args:
      bins_t: ``[F, n]`` uint8 or uint16 feature-major binned matrix.
      vals_t: ``[C, n]`` float32 channel-major values.
      leaf_old: ``[n]`` int32 per-position leaf ids before this round's
        splits; ``leaf_new`` after them. A position whose id changed
        routed to a right child and moves to the back.
      out: optional ``(bins, vals, leaf)`` buffers of the same shapes to
        write into (never the inputs themselves); allocated if None.

    Returns:
      ``((bins, vals, leaf), n_front, cum)``: the columns of bins, vals and
      ``leaf_new``, not-moved ones in source order from column 0 and moved
      ones in source order from ``n_front`` (an int32 device scalar), bit-
      exact; ``cum`` the ``[n]`` int32 inclusive prefix counts of the moved
      positions (``update_tables``' input). CUDA tensors launch the kernel
      once and read nothing back (``partition_move.launches`` counts the
      launches, ``partition_move.launches_u16`` those on uint16 bins);
      CPU tensors take ``partition_move_plain``.
    """
    _check_inputs(bins_t, vals_t, leaf_old, leaf_new, out)
    dev = bins_t.device
    if dev.type == "cpu":
        return partition_move_plain(bins_t, vals_t, leaf_old, leaf_new, out)
    if dev.type != "cuda":
        raise ValueError(f"no partition-move kernel for device {dev}")
    ob, ov, ol = out if out is not None else _empty_like(bins_t, vals_t,
                                                         leaf_new)
    F, n = bins_t.shape
    C = vals_t.shape[0]
    cum = torch.empty(n, dtype=i32, device=dev)
    n_front = torch.empty((), dtype=i32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev)
    scratch, epoch = kernels.scan_scratch(
        stream, lib.lgbt_partition_scratch_bytes(n))
    wide = bins_t.dtype == torch.uint16
    fn = lib.lgbt_partition_move_u16 if wide else lib.lgbt_partition_move
    rc = fn(
        bins_t.data_ptr(), vals_t.data_ptr(), leaf_old.data_ptr(),
        leaf_new.data_ptr(), n, F, C, ob.data_ptr(), ov.data_ptr(),
        ol.data_ptr(), cum.data_ptr(), n_front.data_ptr(),
        scratch.data_ptr(), epoch, stream.cuda_stream)
    kernels.check(rc, "partition_move")
    kernels.scan_launched(stream, epoch)
    partition_move.launches += 1
    partition_move.launches_u16 += int(wide)
    return (ob, ov, ol), n_front, cum


partition_move.launches = 0
partition_move.launches_u16 = 0


def _lib() -> ctypes.CDLL:
    lib = kernels.load("partition")
    if lib.lgbt_partition_move.argtypes is None:
        for fn in (lib.lgbt_partition_move, lib.lgbt_partition_move_u16):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p] * 6 + [ctypes.c_uint]
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        q = lib.lgbt_partition_scratch_bytes
        q.argtypes = [ctypes.c_int]
        q.restype = ctypes.c_longlong
    return lib


def span_budgets(n_rows: int, n_spans: int, min_budget: int = 256
                 ) -> Tuple[int, ...]:
    """Power-of-two span-budget ladder: budgets S with
    ``n_spans * S < n_rows``, so a span round never scans more rows than
    the masked full scan it replaces (the caller's fallback)."""
    budgets = []
    s = min_budget
    while s < n_rows and n_spans * s < n_rows:
        budgets.append(s)
        s *= 2
    return tuple(budgets)


def slice_spans(bins_p: torch.Tensor, vals_p: torch.Tensor,
                leaf_p: torch.Tensor, offs: torch.Tensor, cnts: torch.Tensor,
                budget: int) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The K children's padded row spans as one histogram input: K
    ``budget``-wide column windows (starts clamped into range) of the
    feature-major arrays, concatenated. Positions inside a window that
    belong to a NEIGHBOURING leaf get leaf id -1, so each row of each
    elected child contributes once, to its own lane: a -1 row matches no
    lane of ``multi_leaf_histogram``, inactive -1 lanes included. The
    windows are one device gather: no host read of the offsets."""
    n = leaf_p.shape[0]
    S = int(budget)
    dev = leaf_p.device
    starts = offs.clamp(0, n - S).to(torch.int64)
    rel = torch.arange(S, dtype=torch.int64, device=dev)
    cols = (starts[:, None] + rel[None, :]).reshape(-1)        # [K * S]
    lo = (offs.to(torch.int64) - starts)[:, None]
    keep = (rel[None, :] >= lo) & (rel[None, :] < lo + cnts[:, None])
    lcat = torch.where(keep.reshape(-1), leaf_p[cols], -1).to(i32)
    return (bins_p.index_select(1, cols), vals_p.index_select(1, cols),
            lcat)
