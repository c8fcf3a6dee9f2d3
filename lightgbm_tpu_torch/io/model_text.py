"""LightGBM-compatible model text serialization.

Reference: ``GBDT::SaveModelToString`` / ``LoadModelFromString``
(src/boosting/gbdt_model_text.cpp, UNVERIFIED — empty mount, see SURVEY.md
banner). Writing the reference's versioned text format gives free interop:
models trained here load in stock LightGBM and vice versa, and it doubles
as the checkpoint/resume format (snapshot_freq, init_model continuation).

Notes on faithful quirks:
- ``decision_type`` packs: bit0 = categorical split, bit1 = default_left,
  bits 2-3 = missing type (0 none / 1 zero / 2 NaN).
- boost-from-average init scores are folded into the first tree's leaf
  values at save time (the reference's AddBias), so the file is
  self-contained: prediction = sum of tree outputs.
- ``split_feature`` uses ORIGINAL feature indices (pre feature-dropping),
  unlike the in-engine trees which index used features.

A copy of ``lightgbm_tpu/io/model_text.py`` for the parts this package
ports: the text written for the same trees is byte-equal to the JAX
package's. Linear leaves, SHAP contributions, JSON dumps and C export are
not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..tree import Tree
from ..utils import log

_MISSING_CODE = {"none": 0, "zero": 1, "nan": 2}
_MISSING_DECODE = {v: k for k, v in _MISSING_CODE.items()}


@dataclasses.dataclass
class HostModel:
    """A fully host-side model: trees + metadata, predict + (de)serialize."""

    trees: List[Tree]
    num_class: int = 1
    num_tree_per_iteration: int = 1
    objective_str: str = "regression"
    feature_names: List[str] = dataclasses.field(default_factory=list)
    feature_infos: List[str] = dataclasses.field(default_factory=list)
    max_feature_idx: int = 0
    label_index: int = 0
    average_output: bool = False
    params: Dict[str, str] = dataclasses.field(default_factory=dict)
    # per-node missing type codes per tree (parallel to split arrays)
    missing_types: Optional[List[np.ndarray]] = None
    # category-value lists for pandas category-dtype input columns
    # (stock lightgbm's pandas_categorical model-file field)
    pandas_categorical: Optional[list] = None

    # ------------------------------------------------------------------
    @staticmethod
    def from_engine(engine, config) -> "HostModel":
        ds = engine.train_set
        used = ds.used_features
        trees: List[Tree] = []
        missing_types: List[np.ndarray] = []
        for ti, t in enumerate(engine.models):
            t2 = Tree(**{f.name: getattr(t, f.name)
                         for f in dataclasses.fields(Tree)})
            # map used-feature indices -> original feature indices
            t2.split_feature = np.array(
                [used[int(f)] for f in t.split_feature], dtype=np.int32)
            # zero-missing features serialize as missing_type NONE: this
            # learner bins NaN into the zero bin and routes zeros by
            # threshold (never by default-direction), and stock LightGBM
            # with mt=none converts NaN to 0 at predict — identical
            # routing; writing mt=zero would make stock route
            # |x|<=1e-35 by a default_left this learner never fits
            mt = np.array(
                [0 if ds.bin_mappers[int(f)].missing_type == "zero"
                 else _MISSING_CODE[ds.bin_mappers[int(f)].missing_type]
                 for f in t2.split_feature], dtype=np.int32)
            if t2.is_categorical is not None:
                # categorical missing routes via bitset-miss, not the
                # numerical default-direction machinery
                mt[t2.is_categorical[:len(mt)]] = 0
            t2.node_missing_type = mt    # host traversal NaN semantics
            if ti < engine.num_class and not engine.average_output:
                # fold init score into the first iteration's trees
                # (AddBias); RF trees already carry the bias per-tree
                bias = float(engine.init_scores[ti % engine.num_class])
                t2.leaf_value = t2.leaf_value + bias
                t2.internal_value = t2.internal_value + bias
            trees.append(t2)
            missing_types.append(mt)

        obj = config.objective
        if obj == "regression" and getattr(config, "reg_sqrt", False):
            obj_str = "regression sqrt"        # reference token order
        elif obj == "binary":
            obj_str = f"binary sigmoid:{config.sigmoid:g}"
        elif obj in ("multiclass", "multiclassova"):
            obj_str = f"{obj} num_class:{config.num_class}"
            if obj == "multiclassova":
                obj_str += f" sigmoid:{config.sigmoid:g}"
        elif obj == "lambdarank":
            obj_str = "lambdarank"
        else:
            obj_str = obj

        infos = []
        for f in range(ds.num_total_features):
            m = ds.bin_mappers[f] if f < len(ds.bin_mappers) else None
            if m is None or m.is_trivial:
                infos.append("none")
            elif m.bin_type == "categorical":
                infos.append(":".join(str(int(v))
                                      for v in m.bin_to_cat[1:]))
            else:
                infos.append(f"[{m.min_value:g}:{m.max_value:g}]")

        return HostModel(
            trees=trees,
            num_class=engine.num_class,
            num_tree_per_iteration=engine.num_class,
            objective_str=obj_str,
            feature_names=list(ds.feature_names),
            feature_infos=infos,
            max_feature_idx=ds.num_total_features - 1,
            average_output=engine.average_output,
            params={"objective": obj, "num_leaves": config.num_leaves,
                    "learning_rate": config.learning_rate,
                    "max_bin": config.max_bin,
                    "boosting": config.boosting},
            missing_types=missing_types,
            pandas_categorical=getattr(ds, "pandas_categorical", None),
        )

    # ------------------------------------------------------------------
    def predict(self, data, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_leaf: bool = False) -> np.ndarray:
        from .dataset import Dataset as _DS
        from .dataset import apply_pandas_categorical, is_sparse
        # a frame's category columns become codes under the model's lists
        data = apply_pandas_categorical(data, self.pandas_categorical)
        if is_sparse(data) and data.shape[0] > 0:
            # raw feature values, densified in bounded row chunks
            csr = data.tocsr()
            chunk = 65536
            return np.concatenate([self.predict(
                csr[i:i + chunk].toarray(), raw_score=raw_score,
                start_iteration=start_iteration, num_iteration=num_iteration,
                pred_leaf=pred_leaf) for i in range(0, csr.shape[0], chunk)],
                axis=0)
        X = _DS._to_matrix(data)
        n = X.shape[0]
        total_iters = len(self.trees) // max(self.num_tree_per_iteration, 1)
        if num_iteration <= 0:
            num_iteration = total_iters - start_iteration
        num_iteration = min(num_iteration, total_iters - start_iteration)
        t0 = start_iteration * self.num_tree_per_iteration
        t1 = t0 + num_iteration * self.num_tree_per_iteration
        use = self.trees[t0:t1]
        K = max(self.num_tree_per_iteration, 1)
        if pred_leaf:
            out = np.zeros((n, len(use)), dtype=np.int32)
            for i, t in enumerate(use):
                out[:, i] = t.predict_leaf_raw(X)
            return out
        raw = np.zeros((n, K), dtype=np.float64)
        for i, t in enumerate(use):
            raw[:, (t0 + i) % K] += t.predict_raw(X)
        if self.average_output and len(use):
            raw /= (len(use) // K)
        if raw_score:
            return raw[:, 0] if K == 1 else raw
        return self._transform(raw)

    def _transform(self, raw: np.ndarray) -> np.ndarray:
        obj = self.objective_str.split(" ")[0]
        if obj == "binary":
            sigmoid = 1.0
            for tok in self.objective_str.split(" ")[1:]:
                if tok.startswith("sigmoid:"):
                    sigmoid = float(tok.split(":")[1])
            return 1.0 / (1.0 + np.exp(-sigmoid * raw[:, 0]))
        if obj in ("multiclass", "softmax"):
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        if obj == "multiclassova":
            p = 1.0 / (1.0 + np.exp(-raw))
            return p / p.sum(axis=1, keepdims=True)
        if obj in ("poisson", "gamma", "tweedie"):
            return np.exp(raw[:, 0])
        if obj in ("cross_entropy", "xentropy"):
            return 1.0 / (1.0 + np.exp(-raw[:, 0]))
        if obj == "regression" and "sqrt" in self.objective_str.split(" "):
            r = raw[:, 0]
            return np.sign(r) * r * r
        return raw[:, 0] if raw.shape[1] == 1 else raw


# ---------------------------------------------------------------------------
# serialization
# ---------------------------------------------------------------------------
def _arr(name: str, values, fmt="{}") -> str:
    return f"{name}=" + " ".join(fmt.format(v) for v in values)


def _tree_to_string(t: Tree, missing_type: Optional[np.ndarray]) -> str:
    nn = t.num_nodes
    if missing_type is None:
        missing_type = np.zeros(nn, dtype=np.int32)
    is_cat = (t.is_categorical[:nn].astype(np.int32)
              if t.is_categorical is not None
              else np.zeros(nn, dtype=np.int32))
    num_cat = int(len(t.cat_boundaries) - 1) \
        if t.cat_boundaries is not None else 0
    decision_type = (is_cat
                     | (np.asarray(t.default_left[:nn]).astype(np.int32)
                        * 2)
                     | (missing_type[:nn].astype(np.int32) << 2))
    lines = [
        f"num_leaves={t.num_leaves}",
        f"num_cat={num_cat}",
        _arr("split_feature", t.split_feature[:nn]),
        _arr("split_gain", t.split_gain[:nn], "{:g}"),
        _arr("threshold", t.threshold_real[:nn], "{:.17g}"),
        _arr("decision_type", decision_type),
        _arr("left_child", t.left_child[:nn]),
        _arr("right_child", t.right_child[:nn]),
        _arr("leaf_value", t.leaf_value[:t.num_leaves], "{:.17g}"),
        _arr("leaf_weight", t.leaf_weight[:t.num_leaves], "{:g}"),
        _arr("leaf_count", t.leaf_count[:t.num_leaves]),
        _arr("internal_value", t.internal_value[:nn], "{:g}"),
        _arr("internal_weight", [0.0] * nn, "{:g}"),
        _arr("internal_count", t.internal_count[:nn]),
        "is_linear=0",
        f"shrinkage={t.shrinkage:g}",
    ]
    if num_cat > 0:
        # LightGBM layout: threshold[i] indexes cat_boundaries, whose
        # [idx, idx+1) range delimits uint32 words in cat_threshold
        lines.insert(6, _arr("cat_threshold", t.cat_threshold))
        lines.insert(6, _arr("cat_boundaries", t.cat_boundaries))
    return "\n".join(lines) + "\n"


def save_model_string(model: HostModel,
                      importance_type: str = "split") -> str:
    tree_strs = []
    for i, t in enumerate(model.trees):
        mt = (model.missing_types[i]
              if model.missing_types is not None else None)
        tree_strs.append(f"Tree={i}\n" + _tree_to_string(t, mt) + "\n")
    header = [
        "tree",
        "version=v4",
        f"num_class={model.num_class}",
        f"num_tree_per_iteration={model.num_tree_per_iteration}",
        f"label_index={model.label_index}",
        f"max_feature_idx={model.max_feature_idx}",
        f"objective={model.objective_str}",
        *((["average_output"]) if model.average_output else []),
        "feature_names=" + " ".join(model.feature_names),
        "feature_infos=" + " ".join(model.feature_infos),
        "tree_sizes=" + " ".join(str(len(s)) for s in tree_strs),
        "",
    ]
    out = "\n".join(header) + "\n" + "".join(tree_strs)
    out += "end of trees\n\n"
    # feature importances, sorted desc like the reference; split counts
    # by default, total gain under saved_feature_importance_type=1
    use_gain = importance_type in ("gain", 1, "1")
    imp: Dict[str, float] = {}
    for t in model.trees:
        for j in range(t.num_nodes):
            f = int(t.split_feature[j])
            name = (model.feature_names[f]
                    if f < len(model.feature_names) else f"Column_{f}")
            w = float(t.split_gain[j]) if use_gain else 1
            imp[name] = imp.get(name, 0) + w
    out += "feature_importances:\n"
    for name, cnt in sorted(imp.items(), key=lambda kv: -kv[1]):
        out += f"{name}={cnt:g}\n" if use_gain else f"{name}={cnt}\n"
    out += "\nparameters:\n"
    for k, v in model.params.items():
        out += f"[{k}: {v}]\n"
    import json as _json
    out += ("end of parameters\n\npandas_categorical:"
            + _json.dumps(model.pandas_categorical) + "\n")
    return out


def _parse_kv_block(text: str) -> Dict[str, str]:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if "=" in line:
            k, v = line.split("=", 1)
            out[k] = v
    return out


def _parse_tree_block(block: str) -> (Tree, np.ndarray):
    kv = _parse_kv_block(block)
    num_leaves = int(kv["num_leaves"])
    nn = max(num_leaves - 1, 0)

    def geti(name, size, default=0):
        if name not in kv or not kv[name].strip():
            return np.full(size, default, dtype=np.int32)
        return np.array(kv[name].split(), dtype=np.float64).astype(np.int32)

    def getf(name, size, default=0.0):
        if name not in kv or not kv[name].strip():
            return np.full(size, default, dtype=np.float64)
        return np.array(kv[name].split(), dtype=np.float64)

    decision_type = geti("decision_type", nn)
    default_left = (decision_type & 2) > 0
    missing_type = (decision_type >> 2) & 3
    threshold = getf("threshold", nn)
    num_cat = int(kv.get("num_cat", 0))
    is_categorical = None
    cat_boundaries = None
    cat_threshold = None
    if num_cat > 0:
        is_categorical = (decision_type & 1) > 0
        cat_boundaries = np.array(kv["cat_boundaries"].split(),
                                  dtype=np.int64)
        cat_threshold = np.array(kv["cat_threshold"].split(),
                                 dtype=np.float64).astype(np.uint32)
    if int(kv.get("is_linear", 0)) == 1:
        log.fatal("linear-tree models are not supported by this package "
                  "yet")
    t = Tree(
        num_leaves=num_leaves,
        split_feature=geti("split_feature", nn),
        threshold_bin=np.zeros(nn, dtype=np.int32),
        threshold_real=threshold,
        default_left=default_left,
        left_child=geti("left_child", nn),
        right_child=geti("right_child", nn),
        split_gain=getf("split_gain", nn),
        internal_value=getf("internal_value", nn),
        internal_count=geti("internal_count", nn).astype(np.int64),
        leaf_value=getf("leaf_value", num_leaves),
        leaf_count=geti("leaf_count", num_leaves).astype(np.int64),
        leaf_weight=getf("leaf_weight", num_leaves),
        shrinkage=float(kv.get("shrinkage", 1.0)),
        cat_boundaries=cat_boundaries,
        cat_threshold=cat_threshold,
        is_categorical=is_categorical,
    )
    return t, missing_type


def load_model_string(text: str) -> HostModel:
    if "tree" not in text.splitlines()[0]:
        log.fatal("Model file doesn't specify the model format")
    head, *tree_parts = text.split("\nTree=")
    kv = _parse_kv_block(head)
    trees: List[Tree] = []
    missing_types: List[np.ndarray] = []
    for part in tree_parts:
        body = part.split("\nend of trees")[0]
        # drop the leading tree index line
        body = body.split("\n", 1)[1] if "\n" in body else body
        t, mt = _parse_tree_block(body)
        t.node_missing_type = mt
        trees.append(t)
        missing_types.append(mt)
    pandas_categorical = None
    marker = "\npandas_categorical:"
    if marker in text:
        import json as _json
        line = text.split(marker, 1)[1].split("\n", 1)[0].strip()
        if line:
            try:
                pandas_categorical = _json.loads(line)
            except ValueError:
                log.warning("Malformed pandas_categorical field ignored")
    return HostModel(
        trees=trees,
        num_class=int(kv.get("num_class", 1)),
        num_tree_per_iteration=int(kv.get("num_tree_per_iteration", 1)),
        objective_str=kv.get("objective", "regression"),
        feature_names=kv.get("feature_names", "").split(),
        feature_infos=kv.get("feature_infos", "").split(),
        max_feature_idx=int(kv.get("max_feature_idx", 0)),
        label_index=int(kv.get("label_index", 0)),
        average_output="average_output" in head,
        missing_types=missing_types,
        pandas_categorical=pandas_categorical,
    )
