"""Callback protocol for the training loop.

Reference: python-package/lightgbm/callback.py (UNVERIFIED — empty mount,
see SURVEY.md banner): callbacks receive a ``CallbackEnv`` namedtuple
after each iteration; ``EarlyStopException`` unwinds the loop. The port of
``lightgbm_tpu/callback.py``'s ``log_evaluation``, ``record_evaluation``
and ``early_stopping``; ``reset_parameter`` and the checkpoint callbacks
are not ported yet.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List

from .utils import log


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            parts = [
                f"{name}'s {metric}: {value:g}"
                for name, metric, value, _ in env.evaluation_result_list]
            log.info(f"[{env.iteration + 1}]\t" + "\t".join(parts))
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]
                      ) -> Callable:
    """Append every iteration's evaluation results to ``eval_result``
    (``{data_name: {metric_name: [value, ...]}}``)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _callback(env: CallbackEnv) -> None:
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, []).append(value)
    _callback.order = 20
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """Stop when no valid-set metric (only the first one under
    ``first_metric_only``) has improved by more than ``min_delta`` for
    ``stopping_rounds`` iterations; the train set's metrics never stop
    the run. Raises ``EarlyStopException`` with the best iteration
    (0-based) and its evaluation results."""
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[Any] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]

    def _make_cmp(higher_better: bool) -> Callable:
        if higher_better:
            return lambda x, y: x > y + min_delta
        return lambda x, y: x < y - min_delta

    def _init(env: CallbackEnv) -> None:
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            log.warning("Early stopping is not available without valid "
                        "sets")
            return
        if verbose:
            log.info(f"Training until validation scores don't improve for "
                     f"{stopping_rounds} rounds")
        first_metric[0] = env.evaluation_result_list[0][1]
        for *_head, higher_better in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            cmp_op.append(_make_cmp(higher_better))
            best_score.append(float("-inf") if higher_better
                              else float("inf"))

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        for i, (name, metric, value, _hb) in \
                enumerate(env.evaluation_result_list):
            if best_score_list[i] is None or cmp_op[i](value,
                                                       best_score[i]):
                best_score[i] = value
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            if first_metric_only and first_metric[0] != metric:
                continue
            if name == "training":
                continue  # train metric does not trigger early stopping
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    log.info(f"Early stopping, best iteration is:\n"
                             f"[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    log.info(f"Did not meet early stopping. Best iteration "
                             f"is:\n[{best_iter[i] + 1}]")
                raise EarlyStopException(best_iter[i], best_score_list[i])
    _callback.order = 30
    return _callback
