"""Training entry point: ``train()``.

Reference: python-package/lightgbm/engine.py (UNVERIFIED — empty mount,
see SURVEY.md banner). The port of ``lightgbm_tpu/engine.py::train``: the
callback loop around ``Booster.update`` with valid-set registration and
per-iteration evaluation. Early stopping, checkpoints, continuation and
cross-validation are not ported yet (capabilities.py refuses them).
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
    callbacks = sorted(callbacks or [],
                       key=lambda cb: getattr(cb, "order", 0))
    train_as_valid = bool(valid_sets) and any(vs is train_set
                                              for vs in valid_sets)
    for it in range(num_boost_round):
        booster.update()
        eval_results = []
        if ((booster.engine.valid_data or train_as_valid)
                and (it + 1) % cfg.metric_freq == 0):
            if train_as_valid:
                eval_results.extend(booster.eval_train())
            eval_results.extend(booster.eval_valid())
        env = callback_mod.CallbackEnv(
            model=booster, params=params, iteration=it, begin_iteration=0,
            end_iteration=num_boost_round,
            evaluation_result_list=eval_results)
        for cb in callbacks:
            cb(env)
    booster.best_iteration = booster.current_iteration()
    return booster
