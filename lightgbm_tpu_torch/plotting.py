"""Plotting utilities (reference: python-package/lightgbm/plotting.py).

A copy of lightgbm_tpu/plotting.py (it imports no JAX).  Same public
surface as the reference: plot_importance, plot_split_value_
histogram, plot_metric, plot_tree, create_tree_digraph.  matplotlib and
graphviz are optional — each entry point raises ImportError with the same
kind of message the reference uses when the backend is missing.  They
are imported only when a function is called: the training and serving
paths never import them (the card's machine has neither).
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster

__all__ = [
    "plot_importance",
    "plot_split_value_histogram",
    "plot_metric",
    "plot_tree",
    "create_tree_digraph",
]


def _check_not_tuple_of_2_elements(obj, obj_name):
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a tuple of 2 elements.")


def _float2str(value: float, precision: Optional[int]) -> str:
    return (
        f"{value:.{precision}f}"
        if precision is not None and not isinstance(value, str)
        else str(value)
    )


def _get_booster(booster) -> Booster:
    from .sklearn import LGBMModel

    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be Booster or LGBMModel.")


def _import_matplotlib():
    try:
        import matplotlib.pyplot as plt  # noqa: F401

        return plt
    except ImportError as e:
        raise ImportError("You must install matplotlib and restart your session to plot.") from e


def plot_importance(
    booster,
    ax=None,
    height: float = 0.2,
    xlim: Optional[Tuple[float, float]] = None,
    ylim: Optional[Tuple[float, float]] = None,
    title: Optional[str] = "Feature importance",
    xlabel: Optional[str] = "Feature importance",
    ylabel: Optional[str] = "Features",
    importance_type: str = "auto",
    max_num_features: Optional[int] = None,
    ignore_zero: bool = True,
    figsize: Optional[Tuple[float, float]] = None,
    dpi: Optional[int] = None,
    grid: bool = True,
    precision: Optional[int] = 3,
    **kwargs,
):
    """Horizontal bar chart of feature importance (reference:
    plotting.py plot_importance)."""
    plt = _import_matplotlib()
    bst = _get_booster(booster)
    if importance_type == "auto":
        importance_type = (
            getattr(booster, "importance_type", "split")
            if not isinstance(booster, Booster)
            else "split"
        )
    importance = bst.feature_importance(importance_type=importance_type)
    feature_name = bst.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(
            x + 1,
            y,
            _float2str(x, precision) if importance_type == "gain" else str(int(x)),
            va="center",
        )
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        xlabel = xlabel.replace("@importance_type@", importance_type)
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(
    booster,
    feature: Union[int, str],
    bins=None,
    ax=None,
    width_coef: float = 0.8,
    xlim=None,
    ylim=None,
    title: Optional[str] = "Split value histogram for feature with @index/name@ @feature@",
    xlabel: Optional[str] = "Feature split value",
    ylabel: Optional[str] = "Count",
    figsize=None,
    dpi=None,
    grid: bool = True,
    **kwargs,
):
    """Histogram of a feature's split thresholds across the model
    (reference: plotting.py plot_split_value_histogram)."""
    plt = _import_matplotlib()
    bst = _get_booster(booster)

    hist, split_bins = bst.get_split_value_histogram(feature=feature, bins=bins, xgboost_style=False)
    if np.count_nonzero(hist) == 0:
        raise ValueError(f"Cannot plot split value histogram, because feature {feature} was not used in splitting")
    width = width_coef * (split_bins[1] - split_bins[0])
    centred = (split_bins[:-1] + split_bins[1:]) / 2

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    ax.bar(centred, hist, align="center", width=width, **kwargs)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        range_result = split_bins[-1] - split_bins[0]
        xlim = (split_bins[0] - range_result * 0.2, split_bins[-1] + range_result * 0.2)
    from matplotlib.ticker import MaxNLocator

    ax.set_xlim(xlim)
    ax.yaxis.set_major_locator(MaxNLocator(integer=True))
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        ylim = (0, max(hist) * 1.1)
    ax.set_ylim(ylim)
    if title is not None:
        title = title.replace("@feature@", str(feature))
        title = title.replace("@index/name@", "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(
    booster,
    metric: Optional[str] = None,
    dataset_names: Optional[List[str]] = None,
    ax=None,
    xlim=None,
    ylim=None,
    title: Optional[str] = "Metric during training",
    xlabel: Optional[str] = "Iterations",
    ylabel: Optional[str] = "@metric@",
    figsize=None,
    dpi=None,
    grid: bool = True,
):
    """Plot metric curves recorded by record_evaluation (reference:
    plotting.py plot_metric; accepts the eval-result dict or a fitted
    sklearn estimator, NOT a raw Booster — same contract)."""
    plt = _import_matplotlib()
    from .sklearn import LGBMModel

    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    elif isinstance(booster, Booster):
        raise TypeError(
            "booster must be dict or LGBMModel. To use plot_metric with Booster type, "
            "first record eval results using record_evaluation callback."
        )
    else:
        raise TypeError("booster must be dict or LGBMModel.")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    if dataset_names is None:
        dataset_names_iter = iter(eval_results.keys())
    elif not dataset_names:
        raise ValueError("dataset_names cannot be empty.")
    else:
        dataset_names_iter = iter(dataset_names)

    name = next(dataset_names_iter)
    metrics_for_one = eval_results[name]
    num_metric = len(metrics_for_one)
    if metric is None:
        if num_metric > 1:
            raise ValueError("more than one metric available, pass metric parameter to plot specific one.")
        metric, results = metrics_for_one.popitem()
    else:
        if metric not in metrics_for_one:
            raise KeyError("No given metric in eval results.")
        results = metrics_for_one[metric]
    num_iteration = len(results)
    max_result = max(results)
    min_result = min(results)
    x_ = range(num_iteration)
    ax.plot(x_, results, label=name)

    for name in dataset_names_iter:
        metrics_for_one = eval_results[name]
        results = metrics_for_one[metric]
        max_result = max(*results, max_result)
        min_result = min(*results, min_result)
        ax.plot(x_, results, label=name)

    ax.legend(loc="best")
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
    else:
        xlim = (0, num_iteration)
    ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
    else:
        range_result = max_result - min_result
        ylim = (min_result - range_result * 0.2, max_result + range_result * 0.2)
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ylabel = ylabel.replace("@metric@", metric)
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _to_graphviz(
    tree_info: Dict[str, Any],
    show_info: List[str],
    feature_names: List[str],
    precision: Optional[int],
    orientation: str,
    **kwargs,
):
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("You must install graphviz and restart your session to plot tree.") from e

    def add(root, total_count, parent=None, decision=None):
        """Recursively add node or edge (reference: plotting.py _to_graphviz.add)."""
        if "split_index" in root:
            name = f"split{root['split_index']}"
            if feature_names is not None:
                label = f"<B>{feature_names[root['split_feature']]}</B>"
            else:
                label = f"feature <B>{root['split_feature']}</B>"
            direction = "&#8804;" if root["decision_type"] == "<=" else "="
            label += f" {direction} <B>{_float2str(root['threshold'], precision)}</B>"
            for info in ["split_gain", "internal_value", "internal_weight", "internal_count", "data_percentage"]:
                if info in show_info:
                    output = info.split("_")[-1]
                    if info in {"split_gain", "internal_value", "internal_weight"}:
                        label += f"<br/>{_float2str(root[info], precision)} {output}"
                    elif info == "internal_count":
                        label += f"<br/>{output}: {root[info]}"
                    else:
                        label += f"<br/>{_float2str(root['internal_count'] / total_count * 100, 2)}% of data"
            fillcolor = "white"
            style = ""
            graph.node(name, label=f"<{label}>", shape="rectangle", style=style, fillcolor=fillcolor)
            add(root["left_child"], total_count, name, "yes")
            add(root["right_child"], total_count, name, "no")
        else:  # leaf
            name = f"leaf{root['leaf_index']}"
            label = f"leaf {root['leaf_index']}: "
            label += f"<B>{_float2str(root['leaf_value'], precision)}</B>"
            if "leaf_weight" in show_info:
                label += f"<br/>{_float2str(root['leaf_weight'], precision)} weight"
            if "leaf_count" in show_info:
                label += f"<br/>count: {root['leaf_count']}"
            if "data_percentage" in show_info:
                label += f"<br/>{_float2str(root['leaf_count'] / total_count * 100, 2)}% of data"
            graph.node(name, label=f"<{label}>")
        if parent is not None:
            graph.edge(parent, name, decision)

    graph = Digraph(**kwargs)
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr("graph", nodesep="0.05", ranksep="0.3", rankdir=rankdir)
    if "internal_count" in tree_info["tree_structure"]:
        add(tree_info["tree_structure"], tree_info["tree_structure"]["internal_count"])
    else:
        raise Exception("Cannot plot trees with no split")
    return graph


def create_tree_digraph(
    booster,
    tree_index: int = 0,
    show_info: Optional[List[str]] = None,
    precision: Optional[int] = 3,
    orientation: str = "horizontal",
    **kwargs,
):
    """Create a graphviz Digraph of a single tree (reference: plotting.py
    create_tree_digraph)."""
    bst = _get_booster(booster)
    model = bst.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names", None)
    if tree_index < len(tree_infos):
        tree_info = tree_infos[tree_index]
    else:
        raise IndexError("tree_index is out of range.")
    if show_info is None:
        show_info = []
    return _to_graphviz(tree_info, show_info, feature_names, precision, orientation, **kwargs)


def plot_tree(
    booster,
    ax=None,
    tree_index: int = 0,
    figsize=None,
    dpi=None,
    show_info: Optional[List[str]] = None,
    precision: Optional[int] = 3,
    orientation: str = "horizontal",
    **kwargs,
):
    """Render one tree with matplotlib via graphviz (reference: plotting.py
    plot_tree)."""
    plt = _import_matplotlib()
    from matplotlib.image import imread

    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    graph = create_tree_digraph(
        booster=booster, tree_index=tree_index, show_info=show_info,
        precision=precision, orientation=orientation, **kwargs,
    )
    from io import BytesIO

    s = BytesIO()
    s.write(graph.pipe(format="png"))
    s.seek(0)
    img = imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
