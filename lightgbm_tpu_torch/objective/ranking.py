"""Learning-to-rank objectives: LambdaRank and rank_xendcg.

The port of ``lightgbm_tpu/objective/ranking.py``. Queries are padded to
the longest one, M documents: a ``[Q, M]`` row index (-1 padding). Each
query's documents are sorted by score; LambdaRank's pairs are a ``[T, M]``
tensor per query (the document ranked i < T against every document
ranked j > i), and the queries are batched as ``[Q, T, M]`` tensors, in
chunks of at most ``pair_chunk_elems`` pair elements so that the peak
memory stays bounded at long query lengths. Every query is computed as in
one batch, with the global M and T: chunking changes no bit.

Three choices make the card and the CPU give the same bits:

- every sum over a pair axis, a query or a position is ``tree_sum``: a
  fixed pairwise tree of float32 adds, the same on any device and at any
  chunk size (a library reduction sums in an order that depends on the
  device and the shape, and ``index_add_`` on CUDA adds duplicates in a
  different order on each run);
- the transcendental functions (``sigmoid``, ``log``, ``log2``, ``pow``,
  ``softmax``) run in float64 and round to float32;
- the discount table ``1 / log2(i + 2)`` is built on the host as
  ``1 / (f32(log(i + 2)) * f32(1 / ln 2))``, the log in float64: XLA's
  float32 ``log2`` is not correctly rounded, and of the forms tried this
  one is closest to the JAX package's table (12 of the first 1,300 entries
  differ by an ULP; ``1 / log2`` in float64, rounded, differs at 523).

The gradients therefore agree with the JAX package's within float32
rounding, not bit for bit: XLA sums the pair axes in its own order, and
its table and transcendental functions differ by ULPs.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import Objective, _sigmoid, _softmax
from ..utils import log

# pair elements (T * M per query) a chunk of queries holds at most
PAIR_CHUNK_ELEMS = 1 << 24


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a fixed pairwise tree of elementwise adds: the
    upper half (rounded down) is added onto the lower half until one
    slice is left. The order depends on the length of ``dim`` alone, so
    the result has the same bits on every device and for every size of
    the other dimensions."""
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim)
    while n > 1:
        h = (n + 1) // 2
        y = x.narrow(dim, 0, h).clone()
        y.narrow(dim, 0, n - h).add_(x.narrow(dim, h, n - h))
        x, n = y, h
    return x.select(dim, 0)


def discount_table(M: int) -> np.ndarray:
    """``1 / log2(arange(M) + 2)`` as float32 (the module docstring says
    which form and why)."""
    x = np.arange(M, dtype=np.float64) + 2.0
    ln = np.log(x).astype(np.float32)
    return (np.float32(1.0) / (ln * np.float32(1.0 / math.log(2.0)))) \
        .astype(np.float32)


def _log2(x: torch.Tensor) -> torch.Tensor:
    return torch.log2(x.double()).to(x.dtype)


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).to(x.dtype)


def _pad_queries(query_boundaries: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """A padded ``[Q, M]`` row-index matrix (-1 padding), the per-query
    counts and M."""
    qb = np.asarray(query_boundaries, dtype=np.int64)
    counts = np.diff(qb)
    M = int(counts.max())
    Q = len(counts)
    idx = np.full((Q, M), -1, dtype=np.int64)
    col = np.arange(M)[None, :]
    live = col < counts[:, None]
    idx[live] = (qb[:-1, None] + col)[live]
    return idx, counts, M


class _RankingBase(Objective):
    is_ranking = True

    def __init__(self, config):
        super().__init__(config)
        self._qidx: Optional[torch.Tensor] = None   # [Q, M] row indices
        self._qmask: Optional[torch.Tensor] = None  # [Q, M] validity
        self._qpos: Optional[torch.Tensor] = None   # [Q, M] positions
        self._n_positions = 0
        self.pair_chunk_elems = PAIR_CHUNK_ELEMS

    def setup_queries(self, query_boundaries: np.ndarray, n_rows: int,
                      position=None, device=None) -> None:
        """The padded query layout on ``device``: row indices, validity,
        the flat cells of real documents and their rows (the final row
        write reads them), and the positions when given."""
        if query_boundaries is None:
            log.fatal("Ranking objective requires query/group information")
        idx = _pad_queries(query_boundaries)[0]
        self._qidx = torch.from_numpy(idx).to(device)
        self._qmask = self._qidx >= 0
        flat = np.flatnonzero(idx.ravel() >= 0)
        self._cells = torch.from_numpy(flat).to(device)
        self._cell_rows = torch.from_numpy(idx.ravel()[flat]).to(device)
        self._qpos = None
        if position is not None:
            pos = np.asarray(position, dtype=np.int64).ravel()
            if len(pos) != n_rows:
                log.fatal(f"Length of position ({len(pos)}) does not "
                          f"match number of data ({n_rows})")
            if pos.min() < 0:
                log.fatal("position field must be non-negative")
            padded = np.where(idx >= 0, pos[np.clip(idx, 0, None)], 0)
            self._qpos = torch.from_numpy(padded).to(device)
            self._n_positions = int(pos.max()) + 1
            self._positions_set()

    def _positions_set(self) -> None:
        """Hook: a ``position`` field was attached."""

    @property
    def query_shape(self) -> Tuple[int, int]:
        return tuple(self._qidx.shape)

    def _gather(self, arr: torch.Tensor, fill) -> torch.Tensor:
        """``arr`` at the padded layout, ``fill`` on padding."""
        return torch.where(self._qmask, arr[self._qidx.clamp(min=0)], fill)

    def _to_rows(self, q: torch.Tensor, n: int) -> torch.Tensor:
        """``[Q, M]`` per-document values back to ``[n]`` rows: each real
        row is written once, so no adds and no atomics."""
        out = torch.zeros(n, dtype=q.dtype, device=q.device)
        out[self._cell_rows] = q.reshape(-1)[self._cells]
        return out


class LambdaRank(_RankingBase):
    name = "lambdarank"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.truncation = config.lambdarank_truncation_level
        self.norm = config.lambdarank_norm
        # position debiasing (Unbiased LambdaMART, Hu et al. 2019):
        # per-position propensities t+ (the high document's side) and t-
        # (the low document's), estimated each iteration from the
        # pairwise logistic costs and applied as 1 / (t+ * t-) pair
        # weights; on with a `position` field, or keyed on the score rank
        # with lambdarank_unbiased
        self.unbiased = bool(config.lambdarank_unbiased)
        self.has_pos_state = self.unbiased
        self.bias_reg = float(config.lambdarank_position_bias_regularization)
        p = float(config.lambdarank_bias_p_norm)
        if p < 0.0 and p != -1.0:
            log.fatal("lambdarank_bias_p_norm must be -1 (derive from "
                      "lambdarank_position_bias_regularization) or >= 0, "
                      f"got {p}")
        self.bias_p_norm = p if p >= 0.0 else 1.0 / (1.0 + self.bias_reg)
        self._gains_f32: Optional[np.ndarray] = None
        self._tables_on: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def _positions_set(self) -> None:
        # an explicit position field turns debiasing on without a flag
        if not self.unbiased:
            log.info("position field detected: enabling LambdaRank "
                     "position debiasing (set lambdarank_unbiased=false "
                     "has no effect here; drop the position field to "
                     "train without debiasing)")
        self.unbiased = True
        self.has_pos_state = True
        self._setup_position_groups()

    def _setup_position_groups(self) -> None:
        """The fixed layout of the per-position cost sum: the real
        documents sorted by position (stable), each given a slot in its
        position's row of an ``[S, width]`` table."""
        pos = self._qpos.reshape(-1)[self._cells]
        order = torch.sort(pos, stable=True).indices
        key = pos[order]
        counts = torch.bincount(pos, minlength=self._n_positions)
        start = torch.cumsum(counts, 0) - counts
        self._pos_cells = self._cells[order]
        self._pos_key = key
        self._pos_slot = torch.arange(len(key), device=key.device) \
            - start[key]
        self._pos_width = int(counts.max())

    def init_pos_state(self) -> torch.Tensor:
        """Per-position propensities, all ones: ``[2, S]`` (row 0 = t+ of
        the high document, row 1 = t- of the low one). S is the largest
        position + 1 with a position field, else M (score ranks)."""
        S = self._n_positions if self._qpos is not None \
            else self._qidx.shape[1]
        return torch.ones((2, S), dtype=torch.float32,
                          device=self._qidx.device)

    def prepare(self, label: np.ndarray, weight) -> None:
        max_label = int(label.max())
        if self.config.label_gain:
            gains = np.asarray(self.config.label_gain, dtype=np.float64)
        else:
            gains = (2.0 ** np.arange(max(max_label + 1, 1))) - 1.0
        self._gains_f32 = gains.astype(np.float32)
        self._tables_on = None

    def _tables(self, dev: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The label-gain and discount tables on ``dev`` (made once)."""
        if self._tables_on is None or self._tables_on[0].device != dev:
            M = self._qidx.shape[1]
            self._tables_on = (torch.from_numpy(self._gains_f32).to(dev),
                               torch.from_numpy(discount_table(M)).to(dev))
        return self._tables_on

    def chunk_queries(self, T: int, M: int) -> int:
        return max(1, self.pair_chunk_elems // max(1, T * M))

    def get_gradients(self, score, label, weight, pos_state=None):
        """(grad, hess) ``[n]``, and the new ``[2, S]`` propensities when
        debiasing."""
        if self._qidx is None:
            log.fatal("setup_queries was not called for lambdarank")
        Q, M = self._qidx.shape
        T = min(self.truncation, M)
        dev = score.device
        gains, disc = self._tables(dev)
        use_pos = self.unbiased and self._qpos is not None
        if self.unbiased and pos_state is None:
            pos_state = self.init_pos_state()
        s_all = self._gather(score, float("-inf"))
        y_all = self._gather(label.to(torch.int64), -1)
        grad_q = torch.empty((Q, M), dtype=torch.float32, device=dev)
        hess_q = torch.empty_like(grad_q)
        # per-document costs (high side, low side): in score-rank order
        # when keyed on the rank, in document order with a position field
        cost = (torch.zeros((2, Q, M), dtype=torch.float32, device=dev)
                if self.unbiased else None)
        ar_t = torch.arange(T, device=dev)
        ar_m = torch.arange(M, device=dev)
        j_after_i = ar_m[None, :] > ar_t[:, None]                 # [T, M]
        chunk = self.chunk_queries(T, M)
        for q0 in range(0, Q, chunk):
            q1 = min(Q, q0 + chunk)
            self._chunk(s_all[q0:q1], y_all[q0:q1], self._qmask[q0:q1],
                        None if not use_pos else self._qpos[q0:q1],
                        pos_state, gains, disc, T, j_after_i, ar_t, ar_m,
                        grad_q[q0:q1], hess_q[q0:q1],
                        None if cost is None else cost[:, q0:q1])
        n = score.shape[0]
        grad = self._to_rows(grad_q, n)
        hess = self._to_rows(hess_q, n)
        if weight is not None:
            grad = grad * weight
            hess = hess * weight
        if not self.unbiased:
            return grad, hess
        if use_pos:
            S = self._n_positions
            table = torch.zeros((2, S, self._pos_width),
                                dtype=torch.float32, device=dev)
            table[:, self._pos_key, self._pos_slot] = \
                cost.reshape(2, -1)[:, self._pos_cells]
            c = tree_sum(table, 2)                                # [2, S]
        else:
            c = tree_sum(cost, 1)                                 # [2, M]
        new_state = torch.stack([self._propensity(c[0]),
                                 self._propensity(c[1])])
        return grad, hess, new_state

    def _propensity(self, c: torch.Tensor) -> torch.Tensor:
        """t[r] = (C[r] / C[first]) ^ p, anchored on the first position
        that accumulated cost; positions that saw no pairs stay 1."""
        first = torch.argmax((c > 0).to(torch.int32))   # first true, or 0
        c0 = torch.clamp(c[first], min=1e-20)
        ratio = torch.clamp(c / c0, min=1e-6)
        t = torch.pow(ratio.double(), self.bias_p_norm).to(torch.float32)
        return torch.where(c > 0, torch.clamp(t, min=1e-3), 1.0)

    def _chunk(self, s, y, mask, pos, pos_state, gains, disc, T, j_after_i,
               ar_t, ar_m, grad_out, hess_out, cost_out) -> None:
        """One chunk of queries ``[c, M]``: writes their per-document
        gradients and hessians (and position costs) into the outputs."""
        sig = self.sigmoid
        # score-descending order; padding (-inf) last, ties by index
        order = torch.sort(-s, dim=1, stable=True).indices
        s_sorted = s.gather(1, order)
        y_sorted = y.gather(1, order)
        valid = mask.gather(1, order)
        g_sorted = torch.where(valid, gains[y_sorted.clamp(min=0)], 0.0)
        # max DCG at the truncation level over the ideal order
        ideal = torch.sort(g_sorted, dim=1, descending=True).values
        maxdcg = tree_sum(ideal[:, :T] * disc[:T], 1)
        inv_maxdcg = torch.where(maxdcg > 0, 1.0 / maxdcg, 0.0)

        # pairs: i < T by score rank against every j > i
        si, sj = s_sorted[:, :T, None], s_sorted[:, None, :]
        yi, yj = y_sorted[:, :T, None], y_sorted[:, None, :]
        gi, gj = g_sorted[:, :T, None], g_sorted[:, None, :]
        di, dj = disc[:T, None], disc[None, :]
        pair_ok = (j_after_i & valid[:, None, :] & valid[:, :T, None]
                   & (yi != yj))
        i_is_high = yi > yj
        s_high = torch.where(i_is_high, si, sj)
        s_low = torch.where(i_is_high, sj, si)
        delta = (gi - gj).abs() * (di - dj).abs() \
            * inv_maxdcg[:, None, None]
        rho = _sigmoid(-sig * (s_high - s_low))          # P(wrong order)
        lam = sig * rho * delta
        hess_pair = (sig * sig) * rho * (1.0 - rho) * delta
        lam = torch.where(pair_ok, lam, 0.0)
        hess_pair = torch.where(pair_ok, hess_pair, 0.0)
        if self.unbiased:
            # each pair's high and low document's position: the position
            # field, else the score rank
            if pos is not None:
                p_sorted = pos.gather(1, order)
                ri, rj = p_sorted[:, :T, None], p_sorted[:, None, :]
            else:
                ri, rj = ar_t[None, :, None], ar_m[None, None, :]
            rank_h = torch.where(i_is_high, ri, rj)
            rank_l = torch.where(i_is_high, rj, ri)
            t_hi = pos_state[0][rank_h]
            t_lo = pos_state[1][rank_l]
            # the pairwise logistic cost at the current model, weighted
            # like the lambdas; each side divides by the other side's
            # propensity (Hu et al. eq. 14/15)
            p_cost = torch.where(
                pair_ok, -_log(torch.clamp(1.0 - rho, min=1e-20)) * delta,
                0.0)
            c_hi = p_cost / t_lo
            c_lo = p_cost / t_hi
            # each document's cost as the high and as the low side: the
            # pairs where it is i (a row) plus those where it is j (a
            # column)
            doc_hi = tree_sum(torch.where(i_is_high, 0.0, c_hi), 1)
            doc_hi[:, :T] += tree_sum(torch.where(i_is_high, c_hi, 0.0), 2)
            doc_lo = tree_sum(torch.where(i_is_high, c_lo, 0.0), 1)
            doc_lo[:, :T] += tree_sum(torch.where(i_is_high, 0.0, c_lo), 2)
            if pos is not None:
                # back to document order: the position is the document's
                cost_out[0].scatter_(1, order, doc_hi)
                cost_out[1].scatter_(1, order, doc_lo)
            else:
                cost_out[0].copy_(doc_hi)
                cost_out[1].copy_(doc_lo)
            inv_w = 1.0 / (t_hi * t_lo)
            lam = lam * inv_w
            hess_pair = hess_pair * inv_w

        # the high document gets -lam, the low one +lam
        lam_i = torch.where(i_is_high, -lam, lam)                 # [c, T, M]
        grad_sorted = tree_sum(-lam_i, 1)
        grad_sorted[:, :T] = tree_sum(lam_i, 2) + grad_sorted[:, :T]
        hess_sorted = tree_sum(hess_pair, 1)
        hess_sorted[:, :T] = tree_sum(hess_pair, 2) + hess_sorted[:, :T]
        if self.norm:
            sum_lam = tree_sum(tree_sum(lam.abs(), 2), 1)
            factor = torch.where(sum_lam > 0,
                                 _log2(1.0 + sum_lam) / sum_lam, 1.0)
            grad_sorted = grad_sorted * factor[:, None]
            hess_sorted = hess_sorted * factor[:, None]
        # undo the sort
        grad_out.scatter_(1, order, grad_sorted)
        hess_out.scatter_(1, order, hess_sorted)


class RankXENDCG(_RankingBase):
    name = "rank_xendcg"
    # per-iteration gammas: ``[Q, M]`` uniforms from the noise source
    needs_rng = True

    def prepare(self, label: np.ndarray, weight) -> None:
        pass

    def get_gradients(self, score, label, weight, gammas=None):
        if self._qidx is None:
            log.fatal("setup_queries was not called for rank_xendcg")
        if gammas is None:
            log.fatal("rank_xendcg needs its [Q, M] gammas")
        mask = self._qmask
        s = self._gather(score, float("-inf"))
        y = self._gather(label, 0.0)
        rho = _softmax(s, 1)                       # padding -> 0
        gain = torch.exp2(y.double()).to(torch.float32)
        phi = torch.where(mask, (gain - 1.0) + gammas, 0.0)
        denom = tree_sum(phi, 1)[:, None]
        p = phi / torch.clamp(denom, min=1e-20)
        grad_q = torch.where(mask, rho - p, 0.0)
        hess_q = torch.clamp(torch.where(mask, rho * (1.0 - rho), 0.0),
                             min=1e-16)
        n = score.shape[0]
        grad = self._to_rows(grad_q, n)
        hess = self._to_rows(hess_q, n)
        if weight is not None:
            grad = grad * weight
            hess = hess * weight
        return grad, hess
