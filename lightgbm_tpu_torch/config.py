"""Config system: typed parameters + LightGBM-compatible alias resolution.

Reference: include/LightGBM/config.h + src/io/config_auto.cpp (UNVERIFIED —
empty mount, see SURVEY.md banner). Upstream generates the alias/bounds
tables from docs/Parameters.rst via helpers/parameter_generator.py; here a
single declarative ``_PARAMS`` table is the source of truth, and the
``Config`` dataclass is populated from it. Parameters arrive as a dict of
``key -> value`` (value may be a string, as from CLI ``k=v`` pairs) and are
alias-resolved, type-coerced, and bound-checked centrally, matching
``Config::Set``.

A copy of ``lightgbm_tpu/config.py`` (same table, same aliases) with two
changes: there is no compile cache to configure, and ``device_type`` picks
the torch device — ``"cuda"`` (default) or ``"cpu"``; anything else is
fatal. Which of these parameters the port actually honours is decided in
``capabilities.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from .utils import log

# ---------------------------------------------------------------------------
# Parameter table: name -> (type, default, aliases, (min, max) or None)
# Types: "int", "float", "bool", "str", "int_list", "float_list", "str_list"
# Alias lists follow upstream config_auto.cpp's alias table.
# ---------------------------------------------------------------------------
_P = lambda typ, default, aliases=(), bounds=None: (typ, default, tuple(aliases), bounds)

_PARAMS: Dict[str, Tuple[str, Any, Tuple[str, ...], Optional[Tuple[float, float]]]] = {
    # ---- Core parameters -------------------------------------------------
    "objective": _P("str", "regression",
                    ["objective_type", "app", "application", "loss"]),
    "boosting": _P("str", "gbdt", ["boosting_type", "boost"]),
    "data_sample_strategy": _P("str", "bagging"),
    "num_iterations": _P("int", 100,
                         ["num_iteration", "n_iter", "num_tree", "num_trees",
                          "num_round", "num_rounds", "nrounds",
                          "num_boost_round", "n_estimators", "max_iter"],
                         (0, 1 << 31)),
    "learning_rate": _P("float", 0.1, ["shrinkage_rate", "eta"], (0.0, None)),
    "num_leaves": _P("int", 31, ["num_leaf", "max_leaves", "max_leaf",
                                 "max_leaf_nodes"], (2, 131072)),
    "tree_learner": _P("str", "serial", ["tree", "tree_type",
                                         "tree_learner_type"]),
    "num_threads": _P("int", 0, ["num_thread", "nthread", "nthreads",
                                 "n_jobs"]),
    "device_type": _P("str", "cuda", ["device"]),
    "seed": _P("int", 0, ["random_seed", "random_state"]),
    "deterministic": _P("bool", False),
    # ---- Learning control ------------------------------------------------
    "force_col_wise": _P("bool", False),
    "force_row_wise": _P("bool", False),
    "histogram_pool_size": _P("float", -1.0, ["hist_pool_size"]),
    "max_depth": _P("int", -1),
    "min_data_in_leaf": _P("int", 20, ["min_data_per_leaf", "min_data",
                                       "min_child_samples",
                                       "min_samples_leaf"], (0, None)),
    "min_sum_hessian_in_leaf": _P("float", 1e-3,
                                  ["min_sum_hessian_per_leaf",
                                   "min_sum_hessian", "min_hessian",
                                   "min_child_weight"], (0.0, None)),
    "bagging_fraction": _P("float", 1.0, ["sub_row", "subsample", "bagging"],
                           (0.0, 1.0)),
    "pos_bagging_fraction": _P("float", 1.0, ["pos_sub_row", "pos_subsample",
                                              "pos_bagging"], (0.0, 1.0)),
    "neg_bagging_fraction": _P("float", 1.0, ["neg_sub_row", "neg_subsample",
                                              "neg_bagging"], (0.0, 1.0)),
    "bagging_freq": _P("int", 0, ["subsample_freq"]),
    "bagging_seed": _P("int", 3, ["bagging_fraction_seed"]),
    "feature_fraction": _P("float", 1.0, ["sub_feature", "colsample_bytree"],
                           (0.0, 1.0)),
    "feature_fraction_bynode": _P("float", 1.0,
                                  ["sub_feature_bynode",
                                   "colsample_bynode"], (0.0, 1.0)),
    "feature_fraction_seed": _P("int", 2),
    "extra_trees": _P("bool", False, ["extra_tree"]),
    "extra_seed": _P("int", 6),
    "early_stopping_round": _P("int", 0, ["early_stopping_rounds",
                                          "early_stopping",
                                          "n_iter_no_change"]),
    "early_stopping_min_delta": _P("float", 0.0, [], (0.0, None)),
    "first_metric_only": _P("bool", False),
    "max_delta_step": _P("float", 0.0, ["max_tree_output", "max_leaf_output"]),
    "lambda_l1": _P("float", 0.0, ["reg_alpha", "l1_regularization"],
                    (0.0, None)),
    "lambda_l2": _P("float", 0.0, ["reg_lambda", "lambda",
                                   "l2_regularization"], (0.0, None)),
    "linear_tree": _P("bool", False, ["linear_trees"]),
    "linear_lambda": _P("float", 0.0, [], (0.0, None)),
    "min_gain_to_split": _P("float", 0.0, ["min_split_gain"], (0.0, None)),
    "drop_rate": _P("float", 0.1, ["rate_drop"], (0.0, 1.0)),
    "max_drop": _P("int", 50),
    "skip_drop": _P("float", 0.5, [], (0.0, 1.0)),
    "xgboost_dart_mode": _P("bool", False),
    "uniform_drop": _P("bool", False),
    "drop_seed": _P("int", 4),
    "top_rate": _P("float", 0.2, [], (0.0, 1.0)),
    "other_rate": _P("float", 0.1, [], (0.0, 1.0)),
    "min_data_per_group": _P("int", 100, [], (1, None)),
    "max_cat_threshold": _P("int", 32, [], (1, None)),
    "cat_l2": _P("float", 10.0, [], (0.0, None)),
    "cat_smooth": _P("float", 10.0, [], (0.0, None)),
    "max_cat_to_onehot": _P("int", 4, [], (1, None)),
    "top_k": _P("int", 20, ["topk"], (1, None)),
    "monotone_constraints": _P("int_list", [], ["mc", "monotone_constraint",
                                                "monotonic_cst"]),
    "monotone_constraints_method": _P("str", "basic",
                                      ["monotone_constraining_method",
                                       "mc_method"]),
    "monotone_penalty": _P("float", 0.0, ["monotone_splits_penalty",
                                          "ms_penalty", "mc_penalty"],
                           (0.0, None)),
    "feature_contri": _P("float_list", [], ["feature_contrib", "fc",
                                            "fp", "feature_penalty"]),
    "forcedsplits_filename": _P("str", "", ["fs", "forced_splits_filename",
                                            "forced_splits_file",
                                            "forced_splits"]),
    "refit_decay_rate": _P("float", 0.9, [], (0.0, 1.0)),
    "cegb_tradeoff": _P("float", 1.0, [], (0.0, None)),
    "cegb_penalty_split": _P("float", 0.0, [], (0.0, None)),
    "cegb_penalty_feature_lazy": _P("float_list", []),
    "cegb_penalty_feature_coupled": _P("float_list", []),
    "path_smooth": _P("float", 0.0, [], (0.0, None)),
    "interaction_constraints": _P("str", ""),
    "verbosity": _P("int", 1, ["verbose"]),
    # ---- Dataset parameters ----------------------------------------------
    "max_bin": _P("int", 255, ["max_bins"], (2, None)),
    "max_bin_by_feature": _P("int_list", []),
    "min_data_in_bin": _P("int", 3, [], (1, None)),
    "bin_construct_sample_cnt": _P("int", 200000, ["subsample_for_bin"],
                                   (1, None)),
    "data_random_seed": _P("int", 1, ["data_seed"]),
    "is_enable_sparse": _P("bool", True, ["is_sparse", "enable_sparse",
                                          "sparse"]),
    "enable_bundle": _P("bool", True, ["is_enable_bundle", "bundle"]),
    "max_conflict_rate": _P("float", 0.0, [], (0.0, 1.0)),
    "use_missing": _P("bool", True),
    "zero_as_missing": _P("bool", False),
    "feature_pre_filter": _P("bool", True),
    "pre_partition": _P("bool", False, ["is_pre_partition"]),
    "two_round": _P("bool", False, ["two_round_loading",
                                    "use_two_round_loading"]),
    "header": _P("bool", False, ["has_header"]),
    "label_column": _P("str", "", ["label"]),
    "weight_column": _P("str", "", ["weight"]),
    "group_column": _P("str", "", ["group", "group_id", "query_column",
                                   "query", "query_id"]),
    "ignore_column": _P("str", "", ["ignore_feature", "blacklist"]),
    "categorical_feature": _P("str", "", ["cat_feature",
                                          "categorical_column",
                                          "cat_column",
                                          "categorical_features"]),
    "forcedbins_filename": _P("str", ""),
    "save_binary": _P("bool", False, ["is_save_binary",
                                      "is_save_binary_file"]),
    "precise_float_parser": _P("bool", False),
    "parser_config_file": _P("str", ""),
    # ---- Predict parameters ----------------------------------------------
    "start_iteration_predict": _P("int", 0),
    "num_iteration_predict": _P("int", -1),
    "predict_raw_score": _P("bool", False, ["is_predict_raw_score",
                                            "predict_rawscore",
                                            "raw_score"]),
    "predict_leaf_index": _P("bool", False, ["is_predict_leaf_index",
                                             "leaf_index"]),
    "predict_contrib": _P("bool", False, ["is_predict_contrib", "contrib"]),
    "predict_disable_shape_check": _P("bool", False),
    "pred_early_stop": _P("bool", False),
    "pred_early_stop_freq": _P("int", 10),
    "pred_early_stop_margin": _P("float", 10.0),
    # ---- Convert parameters ----------------------------------------------
    "convert_model_language": _P("str", ""),
    "convert_model": _P("str", "gbdt_prediction.cpp",
                        ["convert_model_file"]),
    # ---- Objective parameters --------------------------------------------
    "objective_seed": _P("int", 5),
    "num_class": _P("int", 1, ["num_classes"], (1, None)),
    "is_unbalance": _P("bool", False, ["unbalance", "unbalanced_sets"]),
    "scale_pos_weight": _P("float", 1.0, [], (0.0, None)),
    "sigmoid": _P("float", 1.0, [], (0.0, None)),
    "boost_from_average": _P("bool", True),
    "reg_sqrt": _P("bool", False),
    "alpha": _P("float", 0.9, [], (0.0, None)),
    "fair_c": _P("float", 1.0, [], (0.0, None)),
    "poisson_max_delta_step": _P("float", 0.7, [], (0.0, None)),
    "tweedie_variance_power": _P("float", 1.5, [], (1.0, 2.0)),
    "lambdarank_truncation_level": _P("int", 30, [], (1, None)),
    "lambdarank_norm": _P("bool", True),
    "label_gain": _P("float_list", []),
    # Position debiasing (rank_objective.hpp position_bias_; UNVERIFIED —
    # empty mount): the reference activates it automatically when the
    # dataset carries a `position` field; the propensity exponent is
    # 1/(1 + lambdarank_position_bias_regularization). We mirror that.
    # `lambdarank_unbiased` is an EXTENSION: force debiasing keyed on
    # score rank when no explicit position field exists.
    "lambdarank_unbiased": _P("bool", False),
    # -1 = derive the propensity exponent as 1/(1+regularization)
    # (reference semantics); >=0 overrides it directly (extension).
    "lambdarank_bias_p_norm": _P("float", -1.0, [], (-1.0, None)),
    "lambdarank_position_bias_regularization": _P("float", 0.0, [],
                                                  (0.0, None)),
    # ---- Metric parameters -----------------------------------------------
    "metric": _P("str_list", [], ["metrics", "metric_types"]),
    "metric_freq": _P("int", 1, ["output_freq"], (1, None)),
    "is_provide_training_metric": _P("bool", False,
                                     ["training_metric",
                                      "is_training_metric",
                                      "train_metric"]),
    "eval_at": _P("int_list", [1, 2, 3, 4, 5],
                  ["ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"]),
    "multi_error_top_k": _P("int", 1, [], (1, None)),
    "auc_mu_weights": _P("float_list", []),
    # ---- Network parameters ----------------------------------------------
    "num_machines": _P("int", 1, ["num_machine"], (1, None)),
    "local_listen_port": _P("int", 12400, ["local_port", "port"]),
    "time_out": _P("int", 120, [], (1, None)),
    "machine_list_filename": _P("str", "", ["machine_list_file",
                                            "machine_list", "mlist"]),
    "machines": _P("str", "", ["workers", "nodes"]),
    # ---- GPU parameters (accepted for compatibility; TPU ignores) --------
    "gpu_platform_id": _P("int", -1),
    "gpu_device_id": _P("int", -1),
    "gpu_use_dp": _P("bool", False),
    "num_gpu": _P("int", 1, [], (1, None)),
    # ---- Quantized training ----------------------------------------------
    "use_quantized_grad": _P("bool", False),
    "num_grad_quant_bins": _P("int", 4),
    "quant_train_renew_leaf": _P("bool", False),
    "stochastic_rounding": _P("bool", True),
    # ---- IO / app --------------------------------------------------------
    "task": _P("str", "train", ["task_type"]),
    "data": _P("str", "", ["train", "train_data", "train_data_file",
                           "data_filename"]),
    "valid": _P("str_list", [], ["test", "valid_data", "valid_data_file",
                                 "test_data", "test_data_file",
                                 "valid_filenames"]),
    "input_model": _P("str", "", ["model_input", "model_in"]),
    "output_model": _P("str", "LightGBM_model.txt",
                       ["model_output", "model_out"]),
    "output_result": _P("str", "LightGBM_predict_result.txt",
                        ["predict_result", "prediction_result",
                         "predict_name", "prediction_name", "pred_name",
                         "name_pred"]),
    "snapshot_freq": _P("int", -1, ["save_period"]),
    "saved_feature_importance_type": _P("int", 0),
    # ---- knobs of the JAX package (recovery, serving, observability, TPU
    # kernels). Kept so params written for lightgbm_tpu parse the same
    # way; capabilities.py refuses every one this port does not honour.
    "checkpoint_dir": _P("str", ""),
    "checkpoint_interval": _P("int", 0, ["checkpoint_freq"], (0, None)),
    "checkpoint_keep": _P("int", 3, [], (1, None)),
    "tpu_fault_inject": _P("str", ""),
    "tpu_fault_marker": _P("str", ""),
    "tpu_elastic_recut": _P("str", "auto"),
    "tpu_heartbeat_dir": _P("str", ""),
    "tpu_model_watch": _P("str", ""),
    "tpu_model_watch_interval": _P("float", 2.0, [], (0.0, None)),
    "tpu_rows_per_block": _P("int", 4096),
    "tpu_donate": _P("str", "auto"),
    "tpu_mesh_shape": _P("str", ""),
    "tpu_double_precision_hist": _P("bool", False),
    "tpu_stream_chunk_rows": _P("int", 500000, [], (100, None)),
    "tpu_leaf_batch": _P("int", 32, [], (1, 256)),
    "tpu_use_pallas": _P("bool", True),
    "tpu_goss_compact": _P("bool", True),
    "tpu_fuse_iters": _P("int", 40, [], (1, 1000)),
    "tpu_hist_reduce": _P("str", "scatter"),
    "tpu_auto_quantize": _P("bool", True),
    "tpu_streaming": _P("str", "auto"),
    "tpu_stream_block_rows": _P("int", 0),
    "tpu_stream_overlap": _P("str", "auto"),
    "tpu_hist_packed_wire": _P("bool", True),
    "tpu_debug_checks": _P("bool", False),
    "tpu_debug": _P("bool", False),
    "tpu_profile_dir": _P("str", ""),
    "tpu_metrics": _P("bool", False),
    "tpu_trace_dir": _P("str", ""),
    "tpu_metrics_dump": _P("str", ""),
    "tpu_metrics_port": _P("int", 0, [], (0, 65535)),
    "tpu_slo_window_s": _P("float", 0.0, [], (0.0, None)),
    "tpu_slo_predict_p99_ms": _P("float", 0.0, [], (0.0, None)),
    "tpu_slo_error_ratio": _P("float", 0.0, [], (0.0, 1.0)),
    "tpu_heartbeat_timeout": _P("float", 0.0, [], (0.0, None)),
    "tpu_metrics_rank_dir": _P("str", ""),
    "tpu_predict_parallel_trees": _P("bool", True),
    "tpu_predict_buckets": _P("bool", True),
    "tpu_predict_chunk_rows": _P("int", 65536, [], (1024, None)),
    "tpu_predict_cache": _P("bool", True),
    "tpu_serve_batch_budget_ms": _P("float", 5.0, [], (0.0, None)),
    "tpu_serve_max_batch_rows": _P("int", 8192, [], (128, None)),
    "tpu_serve_cache_models": _P("int", 8, [], (1, None)),
    "tpu_serve_cache_bytes": _P("int", 0, [], (0, None)),
    "tpu_serve_shard_trees": _P("str", "auto"),
    "tpu_ingest_device": _P("str", "auto"),
    "tpu_ingest_chunk_rows": _P("int", 262144, [], (4096, None)),
    "tpu_ingest_threads": _P("int", 0, [], (0, 256)),
    "tpu_compile_cache_dir": _P("str", ""),
    "tpu_hist_mode": _P("str", "pool"),
    "tpu_hist_partition": _P("str", "auto"),
}


# alias -> canonical name
_ALIASES: Dict[str, str] = {}
for _name, (_t, _d, _al, _b) in _PARAMS.items():
    for _a in _al:
        _ALIASES[_a] = _name
del _name, _t, _d, _al, _b

# torch devices the port trains on ("cuda" = the hand-written kernels)
DEVICE_TYPES = ("cuda", "cpu")

_TRUE_STRINGS = {"true", "1", "t", "yes", "y", "+", "on"}
_FALSE_STRINGS = {"false", "0", "f", "no", "n", "-", "off"}

# Parameters accepted for upstream compatibility but NOT acted on:
# setting a NON-DEFAULT value warns once per distinct (name, value) —
# a fresh run with a DIFFERENT value re-warns, while the 2-3 Config
# objects one train() call builds from the same params don't repeat it
# (never silently ignored — reference parity per config_auto.cpp is
# "every documented param acts"; tests/test_param_audit.py asserts this
# table + source references cover the whole _PARAMS table).
# name -> what's missing.
UNIMPLEMENTED_PARAMS: Dict[str, str] = {
    "parser_config_file": "custom text-parser plugins are not supported",
}
_WARNED_PARAM_VALUES: set = set()

_OBJECTIVE_ALIASES = {
    # objective-name aliases, per src/objective/objective_function.cpp
    "regression": "regression", "regression_l2": "regression",
    "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary", "binary_logloss": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg",
    "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "custom": "custom", "none": "custom", "null": "custom", "na": "custom",
}


def _coerce(name: str, typ: str, value: Any) -> Any:
    """Coerce a raw (possibly string) value to the declared type."""
    if typ == "int":
        if isinstance(value, bool):
            return int(value)
        return int(float(value))  # "1e3" style strings work, as in upstream
    if typ == "float":
        return float(value)
    if typ == "bool":
        if isinstance(value, bool):
            return value
        if isinstance(value, (int, float)):
            return bool(value)
        s = str(value).strip().lower()
        if s in _TRUE_STRINGS:
            return True
        if s in _FALSE_STRINGS:
            return False
        log.fatal(f'Parameter "{name}": cannot parse bool from "{value}"')
    if typ == "str":
        return str(value)
    if typ in ("int_list", "float_list", "str_list"):
        elem = {"int_list": int, "float_list": float, "str_list": str}[typ]
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        elif not isinstance(value, (list, tuple)):
            value = [value]
        return [elem(v) for v in value]
    raise AssertionError(f"unknown param type {typ}")


def _check_bounds(name: str, value: Any, bounds) -> None:
    if bounds is None or not isinstance(value, (int, float)):
        return
    lo, hi = bounds
    if lo is not None and value < lo:
        log.fatal(f'Parameter "{name}"={value} should be >= {lo}')
    if hi is not None and value > hi:
        log.fatal(f'Parameter "{name}"={value} should be <= {hi}')


@dataclasses.dataclass
class Config:
    """Resolved, typed parameter set (mirrors LightGBM's ``Config`` struct)."""

    # populated dynamically from _PARAMS in __init__
    def __init__(self, params: Optional[Dict[str, Any]] = None, **kwargs):
        merged: Dict[str, Any] = dict(params or {})
        merged.update(kwargs)
        for name, (typ, default, _aliases, _bounds) in _PARAMS.items():
            setattr(self, name, list(default) if isinstance(default, list)
                    else default)
        self.raw_params: Dict[str, Any] = {}
        self.update(merged)

    def update(self, params: Dict[str, Any]) -> None:
        """Alias-resolve, coerce, bound-check and apply ``params``."""
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            canonical = _ALIASES.get(key, key)
            if canonical in resolved and resolved[canonical] != value:
                log.warning(
                    f"Parameter {key} (alias of {canonical}) set multiple "
                    f"times; using {resolved[canonical]}")
                continue
            resolved[canonical] = value
        for name, value in resolved.items():
            if value is None:
                continue
            if name not in _PARAMS:
                # unknown params pass through silently like upstream's
                # pass-through of unrecognized keys to Dataset/predict configs
                self.raw_params[name] = value
                continue
            typ, _default, _aliases, bounds = _PARAMS[name]
            coerced = _coerce(name, typ, value)
            _check_bounds(name, coerced, bounds)
            setattr(self, name, coerced)
            self.raw_params[name] = coerced
        self._post_process()

    def _post_process(self) -> None:
        """Cross-parameter fixups, mirroring Config::CheckParamConflict."""
        obj = str(self.objective).lower()
        if obj in _OBJECTIVE_ALIASES:
            self.objective = _OBJECTIVE_ALIASES[obj]
        boosting_aliases = {"gbdt": "gbdt", "gbrt": "gbdt", "dart": "dart",
                            "rf": "rf", "random_forest": "rf", "goss": "goss"}
        b = str(self.boosting).lower()
        if b in boosting_aliases:
            self.boosting = boosting_aliases[b]
        if self.boosting == "goss":
            # upstream maps boosting=goss -> gbdt + data_sample_strategy=goss
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        # tpu_auto_quantize's actual switch lives in GBDT.__init__ —
        # the validated policy is size-gated (>= 500k rows, where the
        # A/B measured it), and row count is unknown here
        self._quantize_auto = False
        learner_aliases = {"serial": "serial", "feature": "feature",
                           "feature_parallel": "feature", "data": "data",
                           "data_parallel": "data", "voting": "voting",
                           "voting_parallel": "voting"}
        tl = str(self.tree_learner).lower()
        if tl not in learner_aliases:
            log.fatal(f"Unknown tree learner type {self.tree_learner}")
        self.tree_learner = learner_aliases[tl]
        if str(self.tpu_hist_reduce) not in ("scatter", "psum"):
            log.fatal(f"Unknown tpu_hist_reduce {self.tpu_hist_reduce!r} "
                      f"(expected 'scatter' or 'psum')")
        if str(self.tpu_hist_mode) not in ("pool", "rebuild"):
            log.fatal(f"Unknown tpu_hist_mode {self.tpu_hist_mode!r} "
                      f"(expected 'pool' or 'rebuild')")
        self.tpu_streaming = coerce_tristate(self.tpu_streaming,
                                             "tpu_streaming")
        self.tpu_stream_overlap = coerce_tristate(self.tpu_stream_overlap,
                                                  "tpu_stream_overlap")
        self.tpu_donate = coerce_tristate(self.tpu_donate, "tpu_donate")
        self.tpu_ingest_device = coerce_tristate(self.tpu_ingest_device,
                                                 "tpu_ingest_device")
        self.tpu_hist_partition = coerce_tristate(self.tpu_hist_partition,
                                                  "tpu_hist_partition")
        self.tpu_serve_shard_trees = coerce_tristate(
            self.tpu_serve_shard_trees, "tpu_serve_shard_trees")
        self.tpu_elastic_recut = coerce_tristate(self.tpu_elastic_recut,
                                                 "tpu_elastic_recut")
        for m in (self.monotone_constraints or []):
            if int(m) not in (-1, 0, 1):
                log.fatal("monotone_constraints must be -1, 0 or 1, "
                          f"got {m}")
        tms = str(self.tpu_mesh_shape).strip()
        if tms:
            try:
                nd = int(tms)
            except ValueError:
                log.fatal(f"tpu_mesh_shape must be a device count, got "
                          f"{tms!r} (N-d mesh shapes like '2x4' are not "
                          f"supported yet)")
            else:
                if nd < 1:
                    log.fatal(f"tpu_mesh_shape must be >= 1, got {nd}")
        mcm = str(self.monotone_constraints_method).lower()
        if mcm not in ("basic", "intermediate", "advanced"):
            log.fatal(f"Unknown monotone_constraints_method {mcm!r}")
        dev = str(self.device_type).lower()
        if dev not in DEVICE_TYPES:
            log.fatal(f"Unknown device_type {self.device_type!r}: this "
                      f"package runs on {' or '.join(DEVICE_TYPES)}")
        self.device_type = dev
        log.set_verbosity(self.verbosity)
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            log.fatal("Cannot set is_unbalance and scale_pos_weight at the "
                      "same time")
        for name, detail in UNIMPLEMENTED_PARAMS.items():
            _t, default, _a, _b = _PARAMS[name]
            val = getattr(self, name)
            dedup_key = (name, repr(val))
            if (name in self.raw_params and val != default
                    and dedup_key not in _WARNED_PARAM_VALUES):
                _WARNED_PARAM_VALUES.add(dedup_key)
                log.warning(f"{name} is accepted but not implemented "
                            f"({detail}); the setting has no effect")

    # -- helpers used across the framework ---------------------------------
    @property
    def num_tree_per_iteration(self) -> int:
        from .capabilities import MULTI_TREE_OBJECTIVES
        if self.objective in MULTI_TREE_OBJECTIVES:
            return max(1, self.num_class)
        return 1

    @staticmethod
    def canonical_name(key: str) -> str:
        return _ALIASES.get(key, key)


def coerce_bool(value: Any) -> bool:
    """Public string-aware bool coercion ('false'/'0'/'off' are False)."""
    return _coerce("<bool>", "bool", value)


_MISSING = object()


def get_param(params: Dict[str, Any], name: str,
              default: Any = _MISSING) -> Any:
    """Alias-resolved, type-coerced, bound-checked read of ONE declared
    parameter from a raw params dict — the sanctioned accessor for
    dict-shaped reads outside ``Config`` (``Dataset.params``, the
    launcher's user params). The config-knob-drift checker
    (``python -m tools.analyze``; docs/static-analysis.md) flags raw
    ``params.get("tpu_...")`` reads, which re-encode each knob's
    default/coercion inline and rot when the declaration moves.

    An absent (or ``None``) knob returns the ``_PARAMS``-declared
    default — pass ``default=`` only to override that (e.g. a
    caller-level kwarg taking precedence)."""
    if name not in _PARAMS:
        log.fatal(f"get_param: {name!r} is not a declared parameter")
    typ, declared, _aliases, bounds = _PARAMS[name]
    value = params.get(name, _MISSING)
    if value is _MISSING:
        for key, v in params.items():
            if _ALIASES.get(key, key) == name:
                value = v
                break
    if value is _MISSING or value is None:
        if default is not _MISSING:
            return default
        return list(declared) if isinstance(declared, list) else declared
    coerced = _coerce(name, typ, value)
    _check_bounds(name, coerced, bounds)
    return coerced


_TRISTATE_VALUES = {"true": "true", "1": "true", "on": "true",
                    "yes": "true",
                    "false": "false", "0": "false", "off": "false",
                    "no": "false",
                    "auto": "auto"}


def coerce_tristate(value: Any, name: str = "parameter") -> str:
    """Normalize an auto/true/false knob to its canonical spelling,
    accepting the same bool spellings coerce_bool does ('on'/'1'/'yes',
    'off'/'0'/'no') — Config validation and Dataset-side param reads
    share this one accept-list."""
    v = _TRISTATE_VALUES.get(str(value).strip().lower())
    if v is None:
        log.fatal(f"Unknown {name} {value!r} (expected 'auto', "
                  f"'true'/'1'/'on'/'yes' or 'false'/'0'/'off'/'no')")
    return v
