"""Text-file data: CSV, TSV and LibSVM.

Copy of ``lightgbm_tpu/io/loader.py`` for the port (reference: LightGBM's
DatasetLoader::LoadFromFile, src/io/dataset_loader.cpp:203, and the format
detection of Parser::CreateParser, src/io/parser.cpp): the format from the
file's extension or its first line, an optional ``header``, the label,
weight and query columns (``label_column``, ``weight_column``,
``group_column``) and ``ignore_column`` by index or as ``name:<column>``,
and the ``<data>.weight`` and ``<data>.query`` sidecar files. Parsing is
numpy on the host; the arrays feed ``Dataset`` as any matrix does.

``two_round=True`` is the reference's memory-bounded two-pass load: the
first pass scans the file once for each row's byte offset and its label,
weight and query cells; then a ``TextFileSequence`` over the offsets feeds
``BinnedDataset.construct_from_sequences``, so the dense ``[N, F]``
float64 matrix is never made. ``register_parser(name, fn)`` adds a line
parser that a ``parser_config_file`` (JSON ``{"className": name}``) picks.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..basic import Sequence


def _detect_format(path: str, line: str) -> str:
    lower = path.lower()
    for ext, fmt in ((".csv", "csv"), (".tsv", "tsv"), (".svm", "libsvm"),
                     (".libsvm", "libsvm")):
        if lower.endswith(ext):
            return fmt
    # auto-detect like the reference Parser::CreateParser: LibSVM tokens
    # look like idx:value
    tokens = line.replace("\t", " ").split()
    if any(":" in t for t in tokens[1:3]):
        return "libsvm"
    return "tsv" if "\t" in line else "csv"


def _cell_float(v: str) -> float:
    """One metadata cell -> float; empty/unparsable cells are NaN (the
    one-round loader's ``np.genfromtxt`` semantics)."""
    v = v.strip()
    if not v:
        return float("nan")
    try:
        return float(v)
    except ValueError:
        return float("nan")


def _group_sizes_from_ids(gid: np.ndarray) -> np.ndarray:
    """Consecutive identical group ids -> group sizes (reference query
    files; shared by the one-round, two-round, and plugin loaders)."""
    change = np.flatnonzero(np.diff(gid)) + 1
    bounds = np.concatenate([[0], change, [len(gid)]])
    return np.diff(bounds)


def _parse_column_spec(spec: str, names) -> Optional[int]:
    """'0' or 'name:label_col' column addressing (reference:
    config.h label_column docs)."""
    if spec in ("", None):
        return None
    spec = str(spec)
    if spec.startswith("name:"):
        return list(names).index(spec[5:])
    return int(spec)


# -- custom parser plugins (reference: pluggable ParserFactory via
# parser_config_file, src/io/parser.cpp Parser::CreateParser) ----------------
# The reference loads native parser plugins from a shared library named in a
# JSON config file; here, as in the JAX package, plugins are Python
# callables registered by name, which cover the same role (turn one text
# line into (features, label)).
_PARSER_REGISTRY = {}


def register_parser(name: str, fn) -> None:
    """Register a custom line parser: ``fn(line: str) -> (values, label)``
    where ``values`` is a float sequence. Select it with
    ``parser_config_file`` pointing at JSON ``{"className": "<name>"}``
    (the reference's key for its plugin class)."""
    _PARSER_REGISTRY[str(name)] = fn


def _load_with_plugin(path: str, has_header: bool, parser_config_file: str,
                      weight_column: str = "", group_column: str = "",
                      ignore_column: str = ""):
    import json
    with open(parser_config_file) as fh:
        cfg = json.load(fh)
    name = str(cfg.get("className", cfg.get("parser", "")))
    if name not in _PARSER_REGISTRY:
        raise ValueError(
            f"parser_config_file names parser {name!r} but no such parser "
            "is registered; call lightgbm_tpu_torch.register_parser(name, fn)")
    fn = _PARSER_REGISTRY[name]
    xs, ys = [], []
    with open(path) as fh:
        if has_header:
            fh.readline()
        for line in fh:
            line = line.strip()
            if not line:
                continue
            vals, label = fn(line)
            xs.append(np.asarray(vals, np.float64))
            ys.append(np.nan if label is None else float(label))
    X = np.vstack(xs)
    y = np.asarray(ys, np.float64)
    if np.isnan(y).all():
        y = None
    # weight/group/ignore column specs index the PARSED value columns (the
    # reference's plugin parser feeds the normal column pipeline)
    weight = group = None
    drop = []

    def idx_of(spec):
        spec = str(spec).strip()
        if spec == "":
            return None
        if not spec.isdigit():
            # custom parsers produce unnamed columns; name-based (and
            # negative) specs cannot resolve here
            raise ValueError(
                f"column spec {spec!r} is not supported with a custom "
                "parser; use a non-negative 0-based column index")
        return int(spec)

    wi = idx_of(weight_column)
    gi = idx_of(group_column)
    if wi is not None:
        weight = X[:, wi]
        drop.append(wi)
    if gi is not None:
        # contiguous query-id column -> group sizes
        group = _group_sizes_from_ids(
            X[:, gi].astype(np.int64)).astype(np.int64)
        drop.append(gi)
    for spec in str(ignore_column).split(","):
        j = idx_of(spec)
        if j is not None:
            drop.append(j)
    if drop:
        keep = [j for j in range(X.shape[1]) if j not in set(drop)]
        X = X[:, keep]
    return X, y, weight, group, None


class TextFileSequence(Sequence):
    """Random-access second-round view of a CSV/TSV file.

    A ``lightgbm_tpu_torch.Sequence``, so ``Dataset`` routes it through the
    streaming construction path: ``__getitem__`` seeks to the recorded
    byte offsets and parses only the requested rows, so batch reads
    during streaming construction are one contiguous file read each.
    """

    batch_size = 4096

    def __init__(self, path: str, offsets: np.ndarray, feat_cols,
                 delim: str):
        self.path = path
        self._offsets = offsets          # [N + 1] byte offsets (int64)
        self._feat_cols = list(feat_cols)
        self._delim = delim

    def __len__(self):
        return len(self._offsets) - 1

    def _parse_rows(self, start: int, stop: int) -> np.ndarray:
        with open(self.path, "rb") as fh:
            fh.seek(int(self._offsets[start]))
            blob = fh.read(int(self._offsets[stop] - self._offsets[start]))
        lines = blob.decode().splitlines()
        out = np.empty((stop - start, len(self._feat_cols)), np.float64)
        for r, line in enumerate(ln for ln in lines if ln.strip()):
            vals = line.split(self._delim)
            for c, j in enumerate(self._feat_cols):
                # same tolerance as the one-round loader's genfromtxt:
                # empty/junk cells are NaN, never a parse crash
                out[r, c] = _cell_float(vals[j]) if j < len(vals) \
                    else np.nan
        return out

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            rng = range(*idx.indices(len(self)))
            if not rng:
                return np.empty((0, len(self._feat_cols)), np.float64)
            if rng.step == 1:
                return self._parse_rows(rng.start, rng.stop)
            lo, hi = min(rng), max(rng) + 1
            rows = self._parse_rows(lo, hi)
            return rows[[i - lo for i in rng]]
        i = int(idx)
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"row {idx} out of range for {len(self)} rows")
        return self._parse_rows(i, i + 1)[0]


def _two_round_load(path, fmt, has_header, label_column, weight_column,
                    group_column, ignore_column):
    """First round: one streaming scan recording per-row byte offsets and
    the scalar metadata columns. Returns the Sequence + metadata."""
    from array import array
    delim = "\t" if fmt == "tsv" else ","
    offsets = array("q", [0])          # compact 8-byte/row buffers: the
    label_v = array("d")               # first pass must stay memory-bounded
    weight_v = array("d")              # at 100M-row files, not grow Python
    group_v = array("d")               # object lists
    names = None
    with open(path, "rb") as fh:
        pos = 0
        first = True
        label_idx = weight_idx = group_idx = None
        ignore = set()
        n_cols = None
        for raw in fh:
            pos += len(raw)
            line = raw.decode().strip()
            if first and has_header:
                names = [c.strip() for c in line.split(delim)]
                offsets[0] = pos
                first = False
                continue
            first = False
            if not line:
                offsets[-1] = pos
                continue
            vals = line.split(delim)
            if n_cols is None:
                n_cols = len(vals)

                def col_of(spec):
                    return _parse_column_spec(spec, names or [])

                label_idx = col_of(label_column)
                weight_idx = col_of(weight_column)
                group_idx = col_of(group_column)
                if ignore_column:
                    for part in str(ignore_column).split(","):
                        j = col_of(part)
                        if j is not None:
                            ignore.add(j)
            if label_idx is not None:
                label_v.append(_cell_float(vals[label_idx]))
            if weight_idx is not None:
                weight_v.append(_cell_float(vals[weight_idx]))
            if group_idx is not None:
                group_v.append(_cell_float(vals[group_idx]))
            offsets.append(pos)
    special = {i for i in (label_idx, weight_idx, group_idx)
               if i is not None} | ignore
    feat_cols = [i for i in range(n_cols or 0) if i not in special]
    seq = TextFileSequence(path, np.asarray(offsets, np.int64), feat_cols,
                           delim)
    label = np.asarray(label_v) if len(label_v) else None
    weight = np.asarray(weight_v) if len(weight_v) else None
    group_sizes = (_group_sizes_from_ids(np.asarray(group_v))
                   if len(group_v) else None)
    feat_names = ([names[i] for i in feat_cols] if names else None)
    return seq, label, weight, group_sizes, feat_names


def load_text_file(
    path: str,
    has_header: bool = False,
    label_column: str = "0",
    weight_column: str = "",
    group_column: str = "",
    ignore_column: str = "",
    parser_config_file: str = "",
    two_round: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray],
           Optional[np.ndarray], Optional[list]]:
    """Returns (X, label, weight, group_sizes, feature_names); with
    ``two_round=True`` X is a :class:`TextFileSequence` instead of a dense
    matrix (see the module docstring)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if parser_config_file:
        return _load_with_plugin(path, has_header, parser_config_file,
                                 weight_column, group_column, ignore_column)
    with open(path) as f:
        first = f.readline()
    fmt = _detect_format(path, first if not has_header else "")

    if two_round:
        if fmt == "libsvm":
            import warnings
            warnings.warn("two_round=true is implemented for CSV/TSV; "
                          "LibSVM files load in one round")
        else:
            return _two_round_load(path, fmt, has_header, label_column,
                                   weight_column, group_column,
                                   ignore_column)

    if fmt == "libsvm":
        return _load_libsvm(path, has_header)

    delim = "\t" if fmt == "tsv" else ","
    names = None
    skip = 0
    if has_header:
        names = [c.strip() for c in first.strip().split(delim)]
        skip = 1
    raw = np.genfromtxt(path, delimiter=delim, skip_header=skip,
                        dtype=np.float64)
    if raw.ndim == 1:
        raw = raw.reshape(-1, 1)

    def col_of(spec):
        return _parse_column_spec(spec, names or [])

    label_idx = col_of(label_column)
    weight_idx = col_of(weight_column)
    group_idx = col_of(group_column)
    ignore = set()
    if ignore_column:
        for part in str(ignore_column).split(","):
            idx = col_of(part)
            if idx is not None:
                ignore.add(idx)
    special = {i for i in (label_idx, weight_idx, group_idx)
               if i is not None} | ignore
    feat_cols = [i for i in range(raw.shape[1]) if i not in special]
    X = raw[:, feat_cols]
    label = raw[:, label_idx] if label_idx is not None else None
    weight = raw[:, weight_idx] if weight_idx is not None else None
    group_sizes = None
    if group_idx is not None:
        group_sizes = _group_sizes_from_ids(raw[:, group_idx])
    feat_names = ([names[i] for i in feat_cols] if names else None)
    return X, label, weight, group_sizes, feat_names


def _load_libsvm(path: str, has_header: bool):
    labels = []
    rows = []
    max_idx = -1
    with open(path) as f:
        if has_header:
            f.readline()
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            feats = {}
            for tok in parts[1:]:
                if ":" not in tok:
                    continue
                i, _, v = tok.partition(":")
                i = int(i)
                feats[i] = float(v)
                max_idx = max(max_idx, i)
            rows.append(feats)
    x = np.zeros((len(rows), max_idx + 1))
    for r, feats in enumerate(rows):
        for i, v in feats.items():
            x[r, i] = v
    return x, np.asarray(labels), None, None, None


def load_query_file(path: str) -> Optional[np.ndarray]:
    """``<data>.query`` / ``.group`` sidecar with one group size per line
    (reference: Metadata::LoadQueryBoundaries)."""
    for suffix in (".query", ".group"):
        p = path + suffix
        if os.path.exists(p):
            return np.loadtxt(p, dtype=np.int64).reshape(-1)
    return None


def load_weight_file(path: str) -> Optional[np.ndarray]:
    p = path + ".weight"
    if os.path.exists(p):
        return np.loadtxt(p, dtype=np.float64).reshape(-1)
    return None
