"""The command line: ``python -m lightgbm_tpu_torch config=train.conf
[key=value ...]``.

Copy of ``lightgbm_tpu/cli.py`` for the port (reference: LightGBM's
``lightgbm`` binary, src/main.cpp and Application::Run,
src/application/application.cpp:168-285): ``key=value`` pairs, from a
config file (``#`` comments) and the command line, which wins. Tasks:

* ``train`` (the default): ``data=`` (and ``valid=``/``valid_data=``, comma
  separated) through the text loader (``io/loader.py``), then
  ``engine.train``; the model to ``output_model``, and a snapshot every
  ``snapshot_freq`` iterations;
* ``predict``: ``data=`` and ``input_model=`` to ``output_result`` (one
  row of ``%.9g`` values a row; ``predict_raw_score``,
  ``predict_leaf_index``);
* ``save_binary``: the binned ``data`` to ``<data>.bin`` (or
  ``output_model``);
* ``refit``: ``input_model``'s leaf values fit again on ``data`` with
  ``refit_decay_rate``, to ``output_model``;
* ``convert_model``: ``input_model`` as C++ if-else code
  (``convert_model_language=cpp``) to ``convert_model``.

``train`` and ``refit`` run on the device ``device_type`` names: the card
by default, the CPU with ``device_type=cpu``; without a card the default
raises. ``predict`` (a model loaded from text predicts on the host, ROADMAP
A10e), ``save_binary`` (host binning) and ``convert_model`` run on the host
and say so.

    python -m lightgbm_tpu_torch config=train.conf device_type=cpu
    python -m lightgbm_tpu_torch task=predict data=test.csv \\
        input_model=LightGBM_model.txt
"""
from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from .config import Config, alias_table, resolve_device


def parse_config_file(path: str) -> Dict[str, str]:
    """``key=value`` lines, ``#`` comments (reference:
    Application::LoadParameters, application.cpp:50)."""
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip()
    return out


def _truthy(params, key: str) -> bool:
    return str(params.get(key, "false")).lower() in ("true", "1")


def _load_text(params, path: str):
    """``(X, label, weight, group, feature names)`` of a data file, with the
    config's column options, the sidecar ``.weight`` and ``.query`` files
    where the columns give none."""
    from .io.loader import load_query_file, load_text_file, load_weight_file
    X, label, weight, group, names = load_text_file(
        path, has_header=_truthy(params, "header"),
        label_column=params.get("label_column", "0"),
        weight_column=params.get("weight_column", ""),
        group_column=params.get("group_column", ""),
        parser_config_file=str(params.get("parser_config_file", "") or ""),
        ignore_column=params.get("ignore_column", ""),
        two_round=_truthy(params, "two_round"))
    if weight is None:
        weight = load_weight_file(path)
    if group is None:
        group = load_query_file(path)
    return X, label, weight, group, names


def _load_dataset(params, path: str):
    from .basic import Dataset
    X, label, weight, group, names = _load_text(params, path)
    return Dataset(X, label=label, weight=weight, group=group,
                   feature_name=names or "auto", free_raw_data=False)


def _dense(X) -> np.ndarray:
    """A two-round load's rows as a matrix (prediction reads them all)."""
    return X if isinstance(X, np.ndarray) else X[0:len(X)]


def run(argv=None) -> int:
    """Run one task; 0 on success, 1 on a missing argument or an unknown
    task."""
    from . import engine
    from .basic import Booster
    from .callback import log_evaluation

    params: Dict[str, str] = {}
    for arg in list(sys.argv[1:] if argv is None else argv):
        if "=" not in arg:
            print(f"ignoring argument without '=': {arg}", file=sys.stderr)
            continue
        key, _, value = arg.partition("=")
        if key == "config":
            # the command line overrides the file (application.cpp:56-66)
            params = dict(parse_config_file(value), **params)
        else:
            params[key] = value

    task = params.pop("task", "train")
    at = alias_table()
    if task in ("train", "refit"):
        device = resolve_device(Config(
            {k: v for k, v in params.items() if k in at}))
    if task == "train":
        data = params.pop("data", None)
        if not data:
            print("task=train needs data=<file>", file=sys.stderr)
            return 1
        valid = params.pop("valid", params.pop("valid_data", ""))
        num_round = int(params.pop("num_iterations",
                                   params.pop("num_boost_round", 100)))
        output_model = params.get("output_model", "LightGBM_model.txt")
        ds = _load_dataset(params, data)
        valid_sets = []
        for path in (p for p in valid.split(",") if p):
            vds = _load_dataset(params, path)
            vds.reference = ds
            valid_sets.append(vds)
        bst = engine.train(
            params, ds, num_round, valid_sets=valid_sets or None,
            valid_names=[f"valid_{i}" for i in range(len(valid_sets))]
            or None,
            callbacks=[log_evaluation(1)] if valid_sets else None)
        bst.save_model(output_model)
        print(f"model saved to {output_model} (device {device})")
        return 0

    if task == "predict":
        data = params.pop("data", None)
        input_model = params.pop("input_model", None)
        if not data or not input_model:
            print("task=predict needs data=<file> input_model=<model>",
                  file=sys.stderr)
            return 1
        output_result = params.pop("output_result",
                                   "LightGBM_predict_result.txt")
        X = _dense(_load_text(params, data)[0])
        pred = Booster(model_file=input_model).predict(
            X, raw_score=_truthy(params, "predict_raw_score"),
            pred_leaf=_truthy(params, "predict_leaf_index"))
        np.savetxt(output_result, np.asarray(pred), fmt="%.9g")
        print(f"predictions saved to {output_result} (on the host)")
        return 0

    if task == "save_binary":
        # (reference: kSaveBinary, application.cpp: the binned data as
        # <data>.bin for fast reloads)
        data = params.pop("data", None)
        if not data:
            print("task=save_binary needs data=<file>", file=sys.stderr)
            return 1
        ds = _load_dataset(params, data)
        ds._update_params(params)
        ds.construct()
        out = params.pop("output_model", data + ".bin")
        ds._inner.save_binary(out)
        print(f"binary dataset saved to {out} (on the host)")
        return 0

    if task == "refit":
        # (reference: KRefitTree, application.cpp:268: leaf values learnt
        # again on new data with refit_decay_rate, the trees kept)
        data = params.pop("data", None)
        input_model = params.pop("input_model", None)
        if not data or not input_model:
            print("task=refit needs data=<file> input_model=<model>",
                  file=sys.stderr)
            return 1
        X, label, _, _, _ = _load_text(params, data)
        bst = Booster(params={"device_type": str(device.type)},
                      model_file=input_model)
        bst = bst.refit(_dense(X), label, decay_rate=float(
            params.get("refit_decay_rate", 0.9)))
        output_model = params.get("output_model", "LightGBM_model.txt")
        bst.save_model(output_model)
        print(f"refitted model saved to {output_model} (device {device})")
        return 0

    if task == "convert_model":
        # (reference: kConvertModel, application.cpp:215 -> Tree::ToIfElse)
        input_model = params.pop("input_model", None)
        if not input_model:
            print("task=convert_model needs input_model=<model>",
                  file=sys.stderr)
            return 1
        lang = params.get("convert_model_language", "cpp")
        if lang not in ("cpp", "c++", ""):
            print(f"convert_model_language={lang} is not supported (cpp "
                  "only)", file=sys.stderr)
            return 1
        out = params.get("convert_model", "gbdt_prediction.cpp")
        from .model_io import LoadedGBDT
        with open(input_model) as fh:
            code = LoadedGBDT(fh.read()).to_if_else()
        with open(out, "w") as fh:
            fh.write(code)
        print(f"if-else model written to {out}")
        return 0

    print(f"unknown task: {task}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(run())
