"""Text data parsers: CSV / TSV / LibSVM with auto-detection.

Copy of lightgbm_tpu/io/parser.py (numpy and the native loader).
Reference: src/io/parser.cpp (Parser::CreateParser auto-detect, CSVParser/
TSVParser/LibSVMParser), src/io/dataset_loader.cpp (label/weight/group column
remap, ignore_column, side files `<data>.weight` / `<data>.query`).

A one-round load tokenizes the whole file in the native C++ loader
(native.py over src/native/loader.cpp, OpenMP), which raises where it
cannot be built: unlike the JAX package, nothing falls back to numpy.
``parse_text`` is the plain numpy parser: the two-round load parses its
chunks with it, as the JAX package does, and the tests hold the native
parser to it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..native import parse_file


def _detect_format(first_line: str) -> str:
    head = first_line.strip()
    toks = head.split()
    if len(toks) >= 2 and ":" in toks[1]:
        return "libsvm"
    if "\t" in head:
        return "tsv"
    return "csv"


def parse_text(text: str, fmt: str = "auto") -> Tuple[np.ndarray, np.ndarray, str]:
    """Parse raw text -> (values (N, C) with NaN for missing, first-col array,
    detected format).  For libsvm returns (label, dense features)."""
    lines = [l for l in text.splitlines() if l.strip() and not l.startswith("#")]
    if not lines:
        return np.zeros((0, 0)), np.zeros(0), "csv"
    if fmt == "auto":
        fmt = _detect_format(lines[0])
    if fmt == "libsvm":
        labels = np.zeros(len(lines))
        rows = []
        maxf = -1
        for i, line in enumerate(lines):
            toks = line.split()
            labels[i] = float(toks[0])
            pairs = []
            for t in toks[1:]:
                if ":" not in t:
                    continue
                k, v = t.split(":", 1)
                k = int(k)
                pairs.append((k, float(v)))
                maxf = max(maxf, k)
            rows.append(pairs)
        data = np.zeros((len(lines), maxf + 1))
        for i, pairs in enumerate(rows):
            for k, v in pairs:
                data[i, k] = v
        return data, labels, fmt
    delim = "\t" if fmt == "tsv" else ","
    ncol = lines[0].count(delim) + 1
    data = np.full((len(lines), ncol), np.nan)
    for i, line in enumerate(lines):
        for j, tok in enumerate(line.rstrip("\r").split(delim)[:ncol]):
            tok = tok.strip()
            if tok and tok.lower() not in ("na", "nan", "null", ""):
                try:
                    data[i, j] = float(tok)
                except ValueError:
                    data[i, j] = np.nan
    return data, data[:, 0].copy(), fmt


def _resolve_column(spec: str, header_names: Optional[List[str]]) -> int:
    """LightGBM column spec: integer index, or `name:<col>` against the
    header (reference: DatasetLoader::SetHeader label_idx resolution)."""
    if spec.startswith("name:"):
        name = spec[5:]
        if header_names and name in header_names:
            return header_names.index(name)
        raise ValueError(f"column name {name!r} not found in header")
    return int(spec)



def _file_column_spec(path: str, fmt: str, header: bool, label_column: str,
                      weight_column: str, group_column: str,
                      ignore_column: str):
    """Shared header/format sniffing + column-index resolution for BOTH the
    eager and the two-round loaders (one implementation so the two modes
    cannot drift)."""
    with open(path, "r") as fh:
        first = fh.readline()
    fmt_detected = fmt if fmt != "auto" else _detect_format(first)
    header_names: Optional[List[str]] = None
    if header and fmt_detected != "libsvm":
        delim = "\t" if fmt_detected == "tsv" else ","
        header_names = [t.strip() for t in first.rstrip("\n\r").split(delim)]
    if fmt_detected == "libsvm":
        return fmt_detected, None, -1, -1, -1, []
    label_idx = _resolve_column(label_column, header_names) if label_column else 0
    weight_idx = _resolve_column(weight_column, header_names) if weight_column else -1
    group_idx = _resolve_column(group_column, header_names) if group_column else -1
    ignore_idxs = [
        _resolve_column(t, header_names) for t in (ignore_column or "").split(",") if t
    ]
    return fmt_detected, header_names, label_idx, weight_idx, group_idx, ignore_idxs


def _split_columns(cols: np.ndarray, label_idx: int, weight_idx: int,
                   group_idx: int, ignore_idxs: List[int]):
    """Split a parsed all-columns chunk into (features, label, weight, group)
    with the same out-of-range tolerance in both loaders."""
    ncol = cols.shape[1]
    label = (cols[:, label_idx].copy() if 0 <= label_idx < ncol
             else np.zeros(len(cols)))
    weight = cols[:, weight_idx].copy() if 0 <= weight_idx < ncol else None
    group = cols[:, group_idx].copy() if 0 <= group_idx < ncol else None
    drop = {label_idx, *ignore_idxs}
    if 0 <= weight_idx < ncol:
        drop.add(weight_idx)
    if 0 <= group_idx < ncol:
        drop.add(group_idx)
    keep = [j for j in range(ncol) if j not in drop]
    return cols[:, keep], label, weight, group, keep


def _group_ids_to_sizes(gcol: np.ndarray) -> np.ndarray:
    """Query-id column -> group sizes, preserving file order of query ids
    (reference: Metadata group column semantics)."""
    ids, idx = np.unique(gcol, return_index=True)
    _, counts = np.unique(gcol, return_counts=True)
    order = np.argsort(idx)
    sizes = np.zeros(len(ids), np.int64)
    for rank, o in enumerate(order):
        sizes[rank] = counts[o]
    return sizes


def load_data_file(
    path: str,
    header: bool = False,
    label_column: str = "",
    weight_column: str = "",
    group_column: str = "",
    ignore_column: str = "",
    fmt: str = "auto",
):
    """Load a training/prediction text file.

    Returns dict(data, label, weight, group, feature_names).
    Side files `<path>.weight` and `<path>.query` are honored like the
    reference (Metadata::LoadWeights/LoadQueryBoundaries).
    """
    fmt_detected, header_names, label_idx, weight_idx, group_idx, ignore_idxs = (
        _file_column_spec(path, fmt, header, label_column, weight_column,
                          group_column, ignore_column)
    )

    if fmt_detected == "libsvm":
        data, label = parse_file(path, "libsvm", False, 0)
        weight = group = None
        names = [f"Column_{i}" for i in range(data.shape[1])]
    else:
        # parse ALL columns (label_idx=-1 keeps the label inline so the
        # weight/group columns survive), then slice label/weight/group out
        cols, _ = parse_file(path, fmt_detected, header, -1)
        data, label, weight, group, keep = _split_columns(
            cols, label_idx, weight_idx, group_idx, ignore_idxs
        )
        if header_names:
            names = [header_names[j] for j in keep]
        else:
            names = [f"Column_{j}" for j in keep]

    # side files (reference: Metadata::LoadWeights / LoadQueryBoundaries)
    if weight is None and os.path.exists(path + ".weight"):
        weight = np.loadtxt(path + ".weight", dtype=np.float64).reshape(-1)
    query = None
    if os.path.exists(path + ".query"):
        query = np.loadtxt(path + ".query", dtype=np.int64).reshape(-1)
    elif group is not None:
        query = _group_ids_to_sizes(group)

    return dict(data=data, label=label, weight=weight, group=query,
                feature_names=names)


def _prefetch(it, depth: int = 1):
    """Async double-buffered iteration (reference:
    include/LightGBM/utils/pipeline_reader.h — PipelineReader overlaps the
    next block's read+parse with the consumer's work).  depth=1 is true
    double buffering: one chunk parsing ahead while one is consumed.
    Worker exceptions re-raise at the consuming site; if the consumer exits
    early, the worker is unblocked and the source iterator closed so no
    thread or file handle leaks."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END, _ERR = object(), object()
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            q.put((_ERR, e))
            return
        finally:
            if stop.is_set():
                it.close()  # unwind the source's `with open(...)`
        q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a worker waiting in q.put
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _iter_chunks(path: str, fmt: str, header: bool, chunk_rows: int):
    """Yield parsed (columns, first_col) chunks of a CSV/TSV/LibSVM file
    without ever holding the whole file (reference: TextReader's chunked
    reads + PipelineReader).  LibSVM chunks are as wide as their own widest
    feature index; the caller reconciles widths."""
    buf: List[str] = []
    with open(path, "r") as fh:
        if header and fmt != "libsvm":
            fh.readline()
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            buf.append(line)
            if len(buf) >= chunk_rows:
                yield parse_text("".join(buf), fmt)[0:2]
                buf = []
    if buf:
        yield parse_text("".join(buf), fmt)[0:2]


def load_data_file_two_round(
    path: str,
    binner_factory,
    header: bool = False,
    label_column: str = "",
    weight_column: str = "",
    group_column: str = "",
    ignore_column: str = "",
    fmt: str = "auto",
    sample_cnt: int = 200000,
    chunk_rows: int = 200000,
    seed: int = 1,
    sample_needed: bool = True,
):
    """Two-pass streaming load (reference: DatasetLoader::LoadFromFile with
    two_round=true — the file is read twice and the raw float matrix is
    NEVER materialized): pass 1 reservoir-samples rows and counts them;
    `binner_factory(sample, feature_names)` fits (or supplies) bin mappers;
    pass 2 streams chunks through the binner into a preallocated compact bin
    matrix.  Column semantics are shared with load_data_file via
    _file_column_spec/_split_columns.

    Returns dict(binner, bins, label, weight, group, feature_names).
    """
    fmt_detected, header_names, label_idx, weight_idx, group_idx, ignore_idxs = (
        _file_column_spec(path, fmt, header, label_column, weight_column,
                          group_column, ignore_column)
    )
    rng = np.random.RandomState(seed)

    def split_chunk(cols, lab):
        if fmt_detected == "libsvm":
            return cols, lab, None, None
        return _split_columns(cols, label_idx, weight_idx, group_idx,
                              ignore_idxs)[:4]

    # ---- pass 1: row count + reservoir sample (Vitter's algorithm R) ----
    # (sample_needed=False — a pre-supplied reference binner — only counts
    # rows and reconciles the width; no sample is built)
    sample = None
    n_seen = 0
    n_feat = 0
    for cols, lab in _prefetch(_iter_chunks(path, fmt_detected, header, chunk_rows)):
        feats = split_chunk(cols, lab)[0]
        n_feat = max(n_feat, feats.shape[1])
        n_seen += feats.shape[0]
        if not sample_needed:
            continue
        if feats.shape[1] < n_feat:  # libsvm ragged width
            feats = np.pad(feats, ((0, 0), (0, n_feat - feats.shape[1])))
        if sample is None:
            sample = np.empty((0, n_feat), np.float64)
        elif sample.shape[1] < n_feat:
            sample = np.pad(sample, ((0, 0), (0, n_feat - sample.shape[1])))
        seen_before = n_seen - feats.shape[0]
        need = sample_cnt - len(sample)
        if need > 0:
            sample = np.concatenate([sample, feats[:need].copy()], axis=0)
            rest = feats[need:]
            base = seen_before + min(need, feats.shape[0])
        else:
            rest = feats
            base = seen_before
        if len(rest):
            # vectorized reservoir step: row i replaces slot js[i] when
            # js[i] < sample_cnt, with js[i] uniform on [0, base + i]
            js = (rng.random(len(rest))
                  * (base + np.arange(len(rest)) + 1)).astype(np.int64)
            hit = js < sample_cnt
            sample[js[hit]] = rest[hit]

    if n_seen == 0:
        raise ValueError(f"empty data file: {path}")

    if header_names:
        drop = {label_idx, weight_idx, group_idx, *ignore_idxs}
        names = [header_names[j] for j in range(len(header_names)) if j not in drop]
    else:
        names = [f"Column_{i}" for i in range(n_feat)]

    binner = binner_factory(sample, names)
    del sample
    if binner.num_features > n_feat:
        # a reference binner may be wider than this file (e.g. a LibSVM
        # valid set missing the rarest feature indices): pad to its width
        n_feat = binner.num_features

    # ---- pass 2: stream chunks through the binner into the bin matrix ----
    dtype = np.uint8 if binner.max_num_bins <= 256 else np.int32
    bins = np.empty((n_seen, n_feat), dtype=dtype)
    labels = np.empty(n_seen, np.float64)
    weights = [] if (fmt_detected != "libsvm" and weight_idx >= 0) else None
    groups = [] if (fmt_detected != "libsvm" and group_idx >= 0) else None
    lo = 0
    for cols, lab in _prefetch(_iter_chunks(path, fmt_detected, header, chunk_rows)):
        feats, label, weight, group = split_chunk(cols, lab)
        if fmt_detected == "libsvm":
            label = lab
        if feats.shape[1] < n_feat:
            feats = np.pad(feats, ((0, 0), (0, n_feat - feats.shape[1])))
        hi = lo + feats.shape[0]
        bins[lo:hi] = binner.transform(feats).astype(dtype)
        labels[lo:hi] = label
        if weights is not None:
            # _split_columns already copies, so no chunk view is retained
            weights.append(weight if weight is not None
                           else np.ones(feats.shape[0]))
        if groups is not None:
            groups.append(group if group is not None
                          else np.zeros(feats.shape[0]))
        lo = hi

    weight_arr = np.concatenate(weights) if weights else None
    if weight_arr is None and os.path.exists(path + ".weight"):
        weight_arr = np.loadtxt(path + ".weight", dtype=np.float64).reshape(-1)
    # side-file precedence matches load_data_file: .query wins over a column
    group_arr = None
    if os.path.exists(path + ".query"):
        group_arr = np.loadtxt(path + ".query", dtype=np.int64).reshape(-1)
    elif groups:
        group_arr = _group_ids_to_sizes(np.concatenate(groups))

    return dict(binner=binner, bins=bins, label=labels, weight=weight_arr,
                group=group_arr, feature_names=names)
