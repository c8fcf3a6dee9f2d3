"""Callback protocol for the training loop.

Reference: python-package/lightgbm/callback.py (UNVERIFIED — empty mount,
see SURVEY.md banner): callbacks receive a ``CallbackEnv`` namedtuple
after each iteration. The port of ``lightgbm_tpu/callback.py`` carries
``log_evaluation``; early stopping, evaluation recording and
checkpointing are not ported yet.
"""
from __future__ import annotations

import collections
from typing import Callable

from .utils import log

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

