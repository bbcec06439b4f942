"""Host-side tree model: trimmed arrays + LightGBM text-format serialization.

Copy of lightgbm_tpu/models/tree.py (numpy only): the text format is shared,
so a model written by either package loads in the other, and
tree_to_if_else emits the same C++ source.  tree_from_device takes this
package's TreeArrays moved to numpy (models/gbdt.py does the move).

Reference: src/io/tree.cpp / include/LightGBM/tree.h (Tree::ToString,
Tree::Split recording real-valued thresholds from bin uppers) and
src/boosting/gbdt_model_text.cpp (the `.txt` model format — the interop
contract per SURVEY.md §6.4).

decision_type bitfield (reference: include/LightGBM/tree.h):
  bit 0: categorical;  bit 1: default_left;  bits 2-3: missing type
  (0 = None, 1 = Zero, 2 = NaN).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

K_CATEGORICAL_MASK = 1
K_DEFAULT_LEFT_MASK = 2
_MISSING_TYPE_SHIFT = 2  # reference: kMissingTypeMask >> positions


@dataclass
class Tree:
    """One decision tree in host numpy arrays (trimmed to actual size)."""

    num_leaves: int
    split_feature: np.ndarray  # (M,) i32, M = num_leaves - 1
    threshold: np.ndarray  # (M,) f64 — real-valued
    threshold_bin: Optional[np.ndarray]  # (M,) i32 binned; None for loaded models
    decision_type: np.ndarray  # (M,) u8
    split_gain: np.ndarray  # (M,) f32
    left_child: np.ndarray  # (M,) i32
    right_child: np.ndarray  # (M,) i32
    internal_value: np.ndarray  # (M,) f64
    internal_weight: np.ndarray  # (M,) f64
    internal_count: np.ndarray  # (M,) i64
    leaf_value: np.ndarray  # (L,) f64
    leaf_weight: np.ndarray  # (L,) f64
    leaf_count: np.ndarray  # (L,) i64
    shrinkage: float = 1.0
    # categorical split storage (reference: cat_boundaries_/cat_threshold_)
    num_cat: int = 0
    cat_boundaries: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int32))
    cat_threshold: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    # runtime-only (not serialized): per-node bin-space left mask for binned
    # replay of categorical nodes within the training session
    cat_bin_masks: Optional[dict] = None
    is_linear: bool = False
    # linear-tree leaf models (reference: linear_tree_learner.cpp storage:
    # leaf_const_/leaf_coeff_/leaf_features_): leaf value = leaf_const +
    # sum(coeff * raw[feature]); NaN in any used feature -> leaf_value
    leaf_const: Optional[np.ndarray] = None  # (L,)
    leaf_features: Optional[list] = None  # per-leaf list of feature ids
    leaf_coeff: Optional[list] = None  # per-leaf list of coefficients

    def is_categorical_node(self) -> np.ndarray:
        return (self.decision_type & K_CATEGORICAL_MASK) != 0

    def cat_decision_left(self, node: int, value: float) -> bool:
        """reference: Tree::CategoricalDecision — value in bitset -> left;
        NaN / negative / not-found -> right."""
        if np.isnan(value):
            return False
        iv = int(value)
        if iv < 0:
            return False
        cat_idx = int(self.threshold[node])
        lo = int(self.cat_boundaries[cat_idx])
        hi = int(self.cat_boundaries[cat_idx + 1])
        word = iv // 32
        if word >= hi - lo:
            return False
        return bool((int(self.cat_threshold[lo + word]) >> (iv % 32)) & 1)

    @property
    def num_internal(self) -> int:
        return max(self.num_leaves - 1, 0)

    def default_left(self) -> np.ndarray:
        return (self.decision_type & K_DEFAULT_LEFT_MASK) != 0

    def apply_shrinkage(self, rate: float) -> None:
        """reference: Tree::Shrinkage."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        if self.is_linear and self.leaf_const is not None:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [np.asarray(c) * rate for c in self.leaf_coeff]
        self.shrinkage *= rate

    # ------------------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        """Scalar reference predict on raw values (numpy; used by tests and
        small-batch paths — the hot path is ops/predict.py on device)."""
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        out = np.empty(n, dtype=np.float64)
        if self.num_leaves <= 1:
            out[:] = self.leaf_value[0] if len(self.leaf_value) else 0.0
            return out
        dl = self.default_left()
        is_cat = self.is_categorical_node()
        missing_type = (self.decision_type.astype(np.int32) >> _MISSING_TYPE_SHIFT) & 3
        for i in range(n):
            node = 0
            while node >= 0:
                f = self.split_feature[node]
                v = x[i, f]
                if is_cat[node]:
                    left = self.cat_decision_left(node, v)
                else:
                    mt = missing_type[node]
                    if np.isnan(v) and mt == 2:
                        left = dl[node]
                    elif mt == 1 and (np.isnan(v) or abs(v) <= 1e-35):
                        left = dl[node]
                    else:
                        vv = 0.0 if np.isnan(v) else v
                        left = vv <= self.threshold[node]
                node = self.left_child[node] if left else self.right_child[node]
            out[i] = self.leaf_value[-node - 1]
        return out

    def predict_leaf_batch(self, x: np.ndarray) -> np.ndarray:
        """Vectorized numpy walk over all rows at once (host fallback path for
        categorical ensembles; the numerical hot path is ops/predict.py)."""
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        dl = self.default_left()
        is_cat = self.is_categorical_node()
        mt = (self.decision_type.astype(np.int32) >> _MISSING_TYPE_SHIFT) & 3
        node = np.zeros(n, dtype=np.int64)
        rows = np.arange(n)
        for _ in range(2 * self.num_leaves):
            active = node >= 0
            if not active.any():
                break
            nd = np.where(active, node, 0)
            f = self.split_feature[nd]
            v = x[rows, f]
            nanv = np.isnan(v)
            use_default = ((mt[nd] == 2) & nanv) | (
                (mt[nd] == 1) & (nanv | (np.abs(v) <= 1e-35))
            )
            veff = np.where(nanv, 0.0, v)
            left = np.where(use_default, dl[nd], veff <= self.threshold[nd])
            if is_cat.any():
                iv = veff.astype(np.int64)
                cat_idx = self.threshold[nd].astype(np.int64)
                cat_idx = np.clip(cat_idx, 0, max(self.num_cat - 1, 0))
                lo = self.cat_boundaries[cat_idx].astype(np.int64)
                nw = self.cat_boundaries[cat_idx + 1].astype(np.int64) - lo
                word = iv >> 5
                in_range = (~nanv) & (iv >= 0) & (word < nw)
                widx = lo + np.clip(word, 0, None)
                widx = np.clip(widx, 0, max(len(self.cat_threshold) - 1, 0))
                bits = (
                    self.cat_threshold[widx].astype(np.int64)
                    if len(self.cat_threshold)
                    else np.zeros(n, np.int64)
                )
                left_cat = in_range & (((bits >> (iv & 31)) & 1) != 0)
                left = np.where(is_cat[nd], left_cat, left)
            nxt = np.where(left, self.left_child[nd], self.right_child[nd])
            node = np.where(active, nxt, node)
        return (-node - 1).astype(np.int32)

    def predict_batch(self, x: np.ndarray) -> np.ndarray:
        leaf = self.predict_leaf_batch(x)
        if not self.is_linear or self.leaf_const is None:
            return self.leaf_value[leaf]
        x = np.asarray(x, np.float64)
        out = np.empty(len(leaf), np.float64)
        for l in range(self.num_leaves):
            rows = leaf == l
            if not rows.any():
                continue
            feats = np.asarray(self.leaf_features[l], np.int64)
            if len(feats) == 0:
                out[rows] = self.leaf_value[l]
                continue
            vals = x[np.ix_(rows, feats)]
            ok = np.isfinite(vals).all(axis=1)
            lin = self.leaf_const[l] + vals @ np.asarray(self.leaf_coeff[l], np.float64)
            out[rows] = np.where(ok, lin, self.leaf_value[l])
        return out

    def predict_leaf_binned_batch(self, bins: np.ndarray, binner) -> np.ndarray:
        """Vectorized walk on BINNED data (host; handles categorical nodes via
        bin-space masks).  Used for valid-score replay of categorical trees."""
        bins = np.asarray(bins)
        n = bins.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        m = self.num_internal
        is_cat = self.is_categorical_node()
        dl = self.default_left()
        if self.threshold_bin is None:
            tb = np.zeros(m, np.int32)
            for i in range(m):
                if is_cat[i]:
                    continue
                f = int(self.split_feature[i])
                tb[i] = int(
                    binner.mappers[f].transform(np.asarray([self.threshold[i]]))[0]
                )
            self.threshold_bin = tb
        masks = self._bin_masks(binner) if is_cat.any() else None
        missing_bin = binner.missing_bin_per_feature
        node = np.zeros(n, dtype=np.int64)
        rows = np.arange(n)
        for _ in range(2 * self.num_leaves):
            active = node >= 0
            if not active.any():
                break
            nd = np.where(active, node, 0)
            f = self.split_feature[nd]
            v = bins[rows, f].astype(np.int64)
            is_missing = v == missing_bin[f]
            left = np.where(is_missing, dl[nd], v <= self.threshold_bin[nd])
            if masks is not None:
                left_cat = masks[nd, v]
                left = np.where(is_cat[nd], left_cat, left)
            nxt = np.where(left, self.left_child[nd], self.right_child[nd])
            node = np.where(active, nxt, node)
        return (-node - 1).astype(np.int32)

    def _bin_masks(self, binner) -> np.ndarray:
        """(M, B) bool left-masks per node in bin space; from cat_bin_masks if
        in-session, else reconstructed from the value bitsets."""
        m = self.num_internal
        B = binner.max_num_bins
        out = np.zeros((m, B), dtype=bool)
        is_cat = self.is_categorical_node()
        for i in range(m):
            if not is_cat[i]:
                continue
            if self.cat_bin_masks is not None and i in self.cat_bin_masks:
                mk = self.cat_bin_masks[i]
                out[i, : len(mk)] = mk
            else:
                mapper = binner.mappers[int(self.split_feature[i])]
                for b, cval in enumerate(mapper.categories):
                    out[i, b] = self.cat_decision_left(i, float(cval))
        return out

    def predict_leaf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        out = np.zeros(n, dtype=np.int32)
        if self.num_leaves <= 1:
            return out
        dl = self.default_left()
        is_cat = self.is_categorical_node()
        missing_type = (self.decision_type.astype(np.int32) >> _MISSING_TYPE_SHIFT) & 3
        for i in range(n):
            node = 0
            while node >= 0:
                f = self.split_feature[node]
                v = x[i, f]
                if is_cat[node]:
                    left = self.cat_decision_left(node, v)
                else:
                    mt = missing_type[node]
                    if np.isnan(v) and mt == 2:
                        left = dl[node]
                    elif mt == 1 and (np.isnan(v) or abs(v) <= 1e-35):
                        left = dl[node]
                    else:
                        vv = 0.0 if np.isnan(v) else v
                        left = vv <= self.threshold[node]
                node = self.left_child[node] if left else self.right_child[node]
            out[i] = -node - 1
        return out

    # ------------------------------------------------------------------
    # LightGBM text model format (reference: Tree::ToString in tree.cpp)
    # ------------------------------------------------------------------
    def to_string(self, tree_idx: int, precise: bool = False) -> str:
        # precise=True is the CHECKPOINT form (GBDT.save_model_to_string
        # raw_deltas): every float field round-trips exactly (.17g), so a
        # crash-resume replays bit-identical tree state.  The default
        # keeps the reference's %g widths for the stats fields — its
        # Tree::ToString prints gains/weights/internal values at 6
        # significant digits.
        g = "{:.17g}" if precise else "{:g}"
        m = self.num_internal
        lines = [f"Tree={tree_idx}"]
        lines.append(f"num_leaves={self.num_leaves}")
        lines.append(f"num_cat={self.num_cat}")
        lines.append("split_feature=" + _join_arr(self.split_feature[:m], "{:d}"))
        lines.append("split_gain=" + _join_arr(self.split_gain[:m], g))
        lines.append("threshold=" + _join_arr(self.threshold[:m], "{:.17g}"))
        lines.append("decision_type=" + _join_arr(self.decision_type[:m], "{:d}"))
        lines.append("left_child=" + _join_arr(self.left_child[:m], "{:d}"))
        lines.append("right_child=" + _join_arr(self.right_child[:m], "{:d}"))
        lines.append(
            "leaf_value=" + _join_arr(self.leaf_value[: self.num_leaves], "{:.17g}")
        )
        lines.append(
            "leaf_weight=" + _join_arr(self.leaf_weight[: self.num_leaves], g)
        )
        lines.append("leaf_count=" + _join_arr(self.leaf_count[: self.num_leaves], "{:d}"))
        lines.append("internal_value=" + _join_arr(self.internal_value[:m], g))
        lines.append("internal_weight=" + _join_arr(self.internal_weight[:m], g))
        lines.append("internal_count=" + _join_arr(self.internal_count[:m], "{:d}"))
        if self.num_cat > 0:
            lines.append("cat_boundaries=" + _join_arr(self.cat_boundaries, "{:d}"))
            lines.append("cat_threshold=" + _join_arr(self.cat_threshold, "{:d}"))
        lines.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear and self.leaf_const is not None:
            L = self.num_leaves
            lines.append("leaf_const=" + _join_arr(self.leaf_const[:L], "{:.17g}"))
            lines.append(
                "num_features=" + " ".join(str(len(self.leaf_features[l])) for l in range(L))
            )
            flat_f = [str(int(v)) for l in range(L) for v in self.leaf_features[l]]
            flat_c = ["{:.17g}".format(float(v)) for l in range(L) for v in self.leaf_coeff[l]]
            lines.append("leaf_features=" + " ".join(flat_f))
            lines.append("leaf_coeff=" + " ".join(flat_c))
        lines.append("shrinkage=" + g.format(self.shrinkage))
        lines.append("")
        return "\n".join(lines)

    @classmethod
    def from_string(cls, block: str) -> "Tree":
        kv = {}
        for line in block.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        num_leaves = int(kv["num_leaves"])
        m = max(num_leaves - 1, 0)

        def parse_list(key, dtype, n):
            s = kv.get(key, "")
            if not s:
                return np.zeros(n, dtype=dtype)
            return np.asarray([float(t) for t in s.split()], dtype=dtype)

        num_cat = int(kv.get("num_cat", 0))
        tree = cls(
            num_leaves=num_leaves,
            split_feature=parse_list("split_feature", np.int32, m),
            threshold=parse_list("threshold", np.float64, m),
            # loaded models carry real-valued thresholds only; bin-space
            # thresholds are reconstructed lazily against a binner when the
            # tree is replayed on binned data (Dataset.predict_leaf_binned_tree)
            threshold_bin=None,
            decision_type=parse_list("decision_type", np.float64, m).astype(np.uint8),
            split_gain=parse_list("split_gain", np.float32, m),
            left_child=parse_list("left_child", np.int32, m),
            right_child=parse_list("right_child", np.int32, m),
            internal_value=parse_list("internal_value", np.float64, m),
            internal_weight=parse_list("internal_weight", np.float64, m),
            internal_count=parse_list("internal_count", np.float64, m).astype(np.int64),
            leaf_value=parse_list("leaf_value", np.float64, num_leaves),
            leaf_weight=parse_list("leaf_weight", np.float64, num_leaves),
            leaf_count=parse_list("leaf_count", np.float64, num_leaves).astype(np.int64),
            shrinkage=float(kv.get("shrinkage", 1.0)),
            num_cat=num_cat,
            is_linear=bool(int(kv.get("is_linear", 0))),
        )
        if num_cat > 0:
            tree.cat_boundaries = parse_list("cat_boundaries", np.float64, num_cat + 1).astype(np.int32)
            tree.cat_threshold = parse_list("cat_threshold", np.float64, 0).astype(np.uint32)
        if tree.is_linear and "leaf_const" in kv:
            tree.leaf_const = parse_list("leaf_const", np.float64, num_leaves)
            counts = parse_list("num_features", np.float64, num_leaves).astype(np.int64)
            flat_f = parse_list("leaf_features", np.float64, 0).astype(np.int64)
            flat_c = parse_list("leaf_coeff", np.float64, 0)
            tree.leaf_features, tree.leaf_coeff = [], []
            pos = 0
            for l in range(num_leaves):
                c = int(counts[l]) if l < len(counts) else 0
                tree.leaf_features.append(flat_f[pos:pos + c])
                tree.leaf_coeff.append(flat_c[pos:pos + c])
                pos += c
        return tree


def _join_arr(a, fmt: str) -> str:
    return " ".join(fmt.format(v) for v in np.asarray(a).tolist())


def tree_from_device(
    arrays,  # ops.treegrow.TreeArrays with numpy fields
    binner,  # binning.DatasetBinner
    linear=None,  # (coef (L,K), const (L,), feat_idx (L,K), nfeat (L,))
) -> Tree:
    """Trim fixed-shape device TreeArrays to an exact host Tree, converting
    bin thresholds to real values via the per-feature BinMapper
    (reference: Tree::Split stores BinMapper bin uppers as thresholds)."""
    num_leaves = int(arrays.num_leaves)
    m = max(num_leaves - 1, 0)
    split_feature = np.asarray(arrays.split_feature)[:m].astype(np.int32)
    thr_bin = np.asarray(arrays.threshold_bin)[:m].astype(np.int32)
    dl = np.asarray(arrays.default_left)[:m]
    node_is_cat = (
        np.asarray(arrays.is_cat)[:m]
        if getattr(arrays, "is_cat", None) is not None
        else np.zeros(m, bool)
    )
    node_cat_mask = (
        np.asarray(arrays.cat_mask)[:m] if node_is_cat.any() else None
    )

    thresholds = np.zeros(m, dtype=np.float64)
    decision_type = np.zeros(m, dtype=np.uint8)
    num_cat = 0
    cat_boundaries = [0]
    cat_words: list = []
    cat_bin_masks = {} if node_is_cat.any() else None
    for i in range(m):
        f = int(split_feature[i])
        mapper = binner.mappers[f]
        dt = 0
        if node_is_cat[i]:
            # bin mask -> LightGBM value bitset (reference: Tree::SplitCategorical
            # storing cat_boundaries_/cat_threshold_ over raw category values)
            mask = node_cat_mask[i]
            cat_bin_masks[i] = mask.copy()
            values = mapper.categories[
                np.flatnonzero(mask[: len(mapper.categories)])
            ].astype(np.int64)
            n_words = int(values.max() // 32 + 1) if len(values) else 1
            words = np.zeros(n_words, dtype=np.uint32)
            for v in values:
                if v >= 0:
                    words[v // 32] |= np.uint32(1) << np.uint32(v % 32)
            thresholds[i] = float(num_cat)  # cat idx
            cat_boundaries.append(cat_boundaries[-1] + n_words)
            cat_words.append(words)
            num_cat += 1
            dt |= K_CATEGORICAL_MASK
        else:
            thresholds[i] = mapper.bin_to_threshold(int(thr_bin[i]))
            if dl[i]:
                dt |= K_DEFAULT_LEFT_MASK
            dt |= (mapper.missing_type & 3) << _MISSING_TYPE_SHIFT
        decision_type[i] = dt

    return Tree(
        num_cat=num_cat,
        cat_boundaries=np.asarray(cat_boundaries, np.int32),
        cat_threshold=(
            np.concatenate(cat_words).astype(np.uint32)
            if cat_words
            else np.zeros(0, np.uint32)
        ),
        cat_bin_masks=cat_bin_masks,
        num_leaves=num_leaves,
        split_feature=split_feature,
        threshold=thresholds,
        threshold_bin=thr_bin,
        decision_type=decision_type,
        split_gain=np.asarray(arrays.split_gain)[:m].astype(np.float32),
        left_child=np.asarray(arrays.left_child)[:m].astype(np.int32),
        right_child=np.asarray(arrays.right_child)[:m].astype(np.int32),
        internal_value=np.asarray(arrays.internal_value)[:m].astype(np.float64),
        internal_weight=np.asarray(arrays.internal_weight)[:m].astype(np.float64),
        internal_count=np.asarray(arrays.internal_count)[:m].astype(np.int64),
        leaf_value=np.asarray(arrays.leaf_value)[:num_leaves].astype(np.float64),
        leaf_weight=np.asarray(arrays.leaf_weight)[:num_leaves].astype(np.float64),
        leaf_count=np.asarray(arrays.leaf_count)[:num_leaves].astype(np.int64),
        **_linear_fields(linear, num_leaves),
    )


def _linear_fields(linear, num_leaves: int) -> dict:
    if linear is None:
        return {}
    coef, const, fidx, nfeat = (np.asarray(a) for a in linear)
    return dict(
        is_linear=True,
        leaf_const=const[:num_leaves].astype(np.float64),
        leaf_features=[
            fidx[l, : int(nfeat[l])].astype(np.int64) for l in range(num_leaves)
        ],
        leaf_coeff=[
            coef[l, : int(nfeat[l])].astype(np.float64) for l in range(num_leaves)
        ],
    )


def tree_to_if_else(tree: "Tree", idx: int) -> str:
    """Emit a standalone C++ predict function for one tree
    (reference: Tree::ToIfElse in src/io/tree.cpp, task=convert_model)."""
    lines = [f"double PredictTree{idx}(const double* x) {{"]
    is_cat = tree.is_categorical_node()
    dl = tree.default_left()
    mt = (tree.decision_type.astype(np.int32) >> _MISSING_TYPE_SHIFT) & 3

    def emit(node: int, indent: int) -> None:
        pad = "  " * indent
        if node < 0:
            l = -node - 1
            if tree.is_linear and tree.leaf_const is not None:
                feats = list(np.asarray(tree.leaf_features[l], np.int64))
                if feats:
                    nan_chk = " || ".join(f"std::isnan(x[{fi}])" for fi in feats)
                    terms = " + ".join(
                        f"{float(c):.17g} * x[{fi}]"
                        for fi, c in zip(feats, np.asarray(tree.leaf_coeff[l]))
                    )
                    lines.append(
                        f"{pad}return ({nan_chk}) ? {tree.leaf_value[l]:.17g} : "
                        f"({tree.leaf_const[l]:.17g} + {terms});"
                    )
                    return
                lines.append(f"{pad}return {tree.leaf_value[l]:.17g};")
                return
            lines.append(f"{pad}return {tree.leaf_value[-node - 1]:.17g};")
            return
        f = int(tree.split_feature[node])
        if is_cat[node]:
            cat_idx = int(tree.threshold[node])
            lo = int(tree.cat_boundaries[cat_idx])
            hi = int(tree.cat_boundaries[cat_idx + 1])
            vals = []
            for w in range(lo, hi):
                word = int(tree.cat_threshold[w])
                for bit in range(32):
                    if (word >> bit) & 1:
                        vals.append((w - lo) * 32 + bit)
            conds = " || ".join(f"iv == {v}" for v in vals) or "false"
            lines.append(f"{pad}{{ const int iv = std::isnan(x[{f}]) ? -1 : (int)x[{f}];")
            lines.append(f"{pad}if ({conds}) {{")
            emit(int(tree.left_child[node]), indent + 1)
            lines.append(f"{pad}}} else {{")
            emit(int(tree.right_child[node]), indent + 1)
            lines.append(f"{pad}}} }}")
            return
        thr = float(tree.threshold[node])
        m = int(mt[node])
        v = f"x[{f}]"
        if m == 2:  # NaN routes to default
            cond_default = f"std::isnan({v})"
        elif m == 1:  # Zero (and NaN) route to default
            cond_default = f"(std::isnan({v}) || std::fabs({v}) <= 1e-35)"
        else:
            cond_default = None
        base = f"(std::isnan({v}) ? 0.0 : {v}) <= {thr:.17g}"
        if cond_default is not None:
            goes_left = f"({cond_default}) ? {str(bool(dl[node])).lower()} : ({base})"
        else:
            goes_left = base
        lines.append(f"{pad}if ({goes_left}) {{")
        emit(int(tree.left_child[node]), indent + 1)
        lines.append(f"{pad}}} else {{")
        emit(int(tree.right_child[node]), indent + 1)
        lines.append(f"{pad}}}")

    if tree.num_leaves <= 1:
        val = float(tree.leaf_value[0]) if len(np.atleast_1d(tree.leaf_value)) else 0.0
        lines.append(f"  return {val:.17g};")
    else:
        emit(0, 1)
    lines.append("}")
    return "\n".join(lines)
