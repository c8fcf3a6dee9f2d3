"""Training entry point: ``train()``.

Reference: python-package/lightgbm/engine.py (UNVERIFIED — empty mount,
see SURVEY.md banner). The port of ``lightgbm_tpu/engine.py::train``: the
callback loop around ``Booster.update`` with valid-set registration and
per-iteration evaluation of the valid sets (and of the train set under
``is_provide_training_metric``), and early stopping
(``early_stopping_round``). Checkpoints, continuation and cross-validation
are not ported yet (capabilities.py refuses them).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

from . import callback as callback_mod
from . import capabilities
from .basic import Booster, Dataset
from .config import Config

__all__ = ["train"]


def _resolve_num_boost_round(params: Dict[str, Any],
                             num_boost_round: int) -> int:
    for key in list(params):
        if Config.canonical_name(key) == "num_iterations":
            return int(params.pop(key))
    return num_boost_round


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          callbacks: Optional[List[Callable]] = None,
          fobj: Optional[Callable] = None, init_model=None,
          noise=None) -> Booster:
    """Train a model (mirrors lightgbm.train). ``device_type`` in
    ``params`` picks the device: "cuda" (default) or "cpu". ``noise``
    replaces the per-iteration random draws (utils/random.py)."""
    params = copy.deepcopy(params)
    num_boost_round = _resolve_num_boost_round(params, num_boost_round)
    if callable(params.get("objective")):
        fobj = params.pop("objective")
    capabilities.check(Config(params), fobj=fobj, init_model=init_model)
    booster = Booster(params=params, train_set=train_set, noise=noise)
    cfg = booster.config
    if valid_sets:
        valid_names = valid_names or [f"valid_{i}"
                                      for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, valid_names):
            if vs is train_set:
                continue  # the train set is evaluated via eval_train
            booster.add_valid(vs, name)
    callbacks = list(callbacks or [])
    if cfg.early_stopping_round > 0:
        callbacks.append(callback_mod.early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            verbose=cfg.verbosity >= 1,
            min_delta=cfg.early_stopping_min_delta))
    callbacks.sort(key=lambda cb: getattr(cb, "order", 0))
    train_as_valid = bool(valid_sets) and any(vs is train_set
                                              for vs in valid_sets)
    for it in range(num_boost_round):
        booster.update()
        eval_results = []
        if ((booster.engine.valid_data or train_as_valid
             or cfg.is_provide_training_metric)
                and (it + 1) % cfg.metric_freq == 0):
            if cfg.is_provide_training_metric or train_as_valid:
                eval_results.extend(booster.eval_train())
            eval_results.extend(booster.eval_valid())
        env = callback_mod.CallbackEnv(
            model=booster, params=params, iteration=it, begin_iteration=0,
            end_iteration=num_boost_round,
            evaluation_result_list=eval_results)
        try:
            for cb in callbacks:
                cb(env)
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for name, metric, value, _ in (e.best_score or []):
                booster.best_score.setdefault(name, {})[metric] = value
            break
    if booster.best_iteration < 0:
        booster.best_iteration = booster.current_iteration()
    return booster
