"""Leaf-ordered row partition (tpu_hist_partition).

Reference: ``CUDADataPartition`` (src/treelearner/cuda/cuda_data_partition
.cu, UNVERIFIED — empty mount, see SURVEY.md banner): each leaf's rows are
kept CONTIGUOUS, so the smaller child's histogram scans only that child's
rows and the sibling comes free by subtraction.

The port of ``lightgbm_tpu/ops/partition.py``:

- the histogram source (bins, values and a per-POSITION leaf id) is kept
  reordered so every leaf occupies one span, described by per-leaf
  ``(offset, count)`` tables;
- after each split batch the rows that routed to a right child move
  stably to the back and every other row stably to the front, in one
  move: one int32 ``cumsum`` of the moved mask gives every destination
  (``plan_split_move``), and the tables update from the same prefix sums
  at the few leaf boundaries (``update_tables``);
- each round histograms only the elected children's spans, cut to a
  power-of-two budget from ``span_budgets`` by ``slice_spans``; positions
  of a neighbouring leaf inside a span get leaf id -1.

``move_cols`` applies the move: for CUDA tensors it launches the
hand-written kernel (``csrc/partition.cu``), one pass that scatters each
column to its destination; for CPU tensors it runs ``move_rows_plain``.
The reference's TPU form (``move_cols_tpu``) needs two compaction passes,
a roll and a blend, and carries the leaf ids as an extra float32 channel
through its bf16x3 split; a GPU store to a computed address is exact, so
here the int32 ids move as their own array.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import kernels

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
    cum_p = torch.cat([torch.zeros(1, dtype=i32, device=cum.device), cum])
    return cum_p[pos.clamp(0, cum.shape[0]).to(torch.int64)]


def update_tables(off: torch.Tensor, cnt: torch.Tensor, cum: torch.Tensor,
                  n_front: torch.Tensor, parents: torch.Tensor,
                  new_ids: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """New per-leaf (offset, count) tables after ``plan_split_move``.

    Every leaf that is not a right child (untouched leaves, and left
    children, which keep the parent's slot) shifts left by the moved rows
    before its old offset; right children land in the back region in
    parent-position order.

    Args:
      off / cnt: ``[L+1]`` int32 old tables (slot L = trash).
      cum: inclusive moved-prefix from ``plan_split_move``.
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
    """Plain torch version of the kernel (same contract): an exact
    computed-index scatter ``out[..., dest[r]] = in[..., r]``."""
    ob, ov, ol = out if out is not None else _empty_like(bins_t, vals_t,
                                                         leaf)
    d = dest.to(torch.int64)
    ob[:, d] = bins_t
    ov[:, d] = vals_t
    ol[d] = leaf
    return ob, ov, ol


def _empty_like(bins_t, vals_t, leaf) -> Arrays:
    return (torch.empty_like(bins_t), torch.empty_like(vals_t),
            torch.empty_like(leaf))


def _check_inputs(bins_t, vals_t, leaf, dest, out):
    if bins_t.dtype != torch.uint8 or bins_t.dim() != 2:
        raise ValueError(f"bins_t must be [F, n] uint8, got "
                         f"{tuple(bins_t.shape)} {bins_t.dtype}")
    n = bins_t.shape[1]
    if vals_t.dtype != torch.float32 or vals_t.dim() != 2 \
            or vals_t.shape[1] != n:
        raise ValueError(f"vals_t must be [C, {n}] float32, got "
                         f"{tuple(vals_t.shape)} {vals_t.dtype}")
    for name, t in (("leaf", leaf), ("dest", dest)):
        if t.dtype != i32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be [{n}] int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    tensors = [bins_t, vals_t, leaf, dest]
    if out is not None:
        for src, o in zip((bins_t, vals_t, leaf), out):
            if o.dtype != src.dtype or o.shape != src.shape:
                raise ValueError(f"out buffer {tuple(o.shape)} {o.dtype} "
                                 f"does not match its input "
                                 f"{tuple(src.shape)} {src.dtype}")
            if o.data_ptr() == src.data_ptr():
                raise ValueError("move_cols never works in place: pass a "
                                 "second buffer")
        tensors += list(out)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("move_cols inputs must be contiguous")


def move_cols(bins_t: torch.Tensor, vals_t: torch.Tensor, leaf: torch.Tensor,
              dest: torch.Tensor, out: Optional[Arrays] = None) -> Arrays:
    """Apply the stable front/back permutation of one split batch.

    Args:
      bins_t: ``[F, n]`` uint8 feature-major binned matrix.
      vals_t: ``[C, n]`` float32 channel-major values.
      leaf: ``[n]`` int32 per-position leaf ids (after this round's
        splits).
      dest: ``[n]`` int32 permutation from ``plan_split_move``.
      out: optional ``(bins, vals, leaf)`` buffers of the same shapes to
        write into (never the inputs themselves); allocated if None.

    Returns:
      ``(bins, vals, leaf)`` with column r of each input at column
      ``dest[r]``, bit-exact. CUDA tensors launch the kernel
      (``move_cols.launches`` counts the launches); CPU tensors take
      ``move_rows_plain``.
    """
    _check_inputs(bins_t, vals_t, leaf, dest, out)
    dev = bins_t.device
    if dev.type == "cpu":
        return move_rows_plain(bins_t, vals_t, leaf, dest, out)
    if dev.type != "cuda":
        raise ValueError(f"no partition-move kernel for device {dev}")
    ob, ov, ol = out if out is not None else _empty_like(bins_t, vals_t,
                                                         leaf)
    F, n = bins_t.shape
    C = vals_t.shape[0]
    rc = _lib().lgbt_partition_move(
        bins_t.data_ptr(), vals_t.data_ptr(), leaf.data_ptr(),
        dest.data_ptr(), n, F, C, ob.data_ptr(), ov.data_ptr(),
        ol.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "move_cols")
    move_cols.launches += 1
    return ob, ov, ol


move_cols.launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernels.load("partition")
    fn = lib.lgbt_partition_move
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
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
