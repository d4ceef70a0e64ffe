"""Rules of the PyTorch port (lightgbm_tpu_torch), checked on the CPU.

* the port never loads JAX or the JAX package, and its sources (and
  chip_smoke.py) never import them;
* every module of the port imports on a machine without a card or nvcc;
  the kernel library is built at first use and, without nvcc, that call
  raises a clear RuntimeError;
* the device is explicit: ``cuda`` (the default) without a card raises,
  never falling back to the CPU; unknown devices raise;
* parameters outside the port's slices raise NotImplementedError naming the
  ROADMAP item that brings them; those of the last slice ported train;
  every key of the JAX package's ``PARAMS`` (read from its config.py with
  ``ast``) is read, refused or ignored by the port, never dropped unseen.
"""
import importlib
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.config import IGNORED_PARAMS, PARAMS, Config

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lightgbm_tpu_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+lightgbm_tpu\b(?!_torch)"
    r"|from\s+lightgbm_tpu\b(?!_torch))", re.M)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="lightgbm_tpu_torch."))


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        "import lightgbm_tpu_torch\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'lightgbm_tpu'"
        " or m.startswith('lightgbm_tpu.')]\n"
        "print(repr(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            hit = _FORBIDDEN.search(fh.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_every_module_imports():
    for name in _port_modules():
        importlib.import_module(name)


def test_kernel_library_needs_nvcc_at_first_use(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_kernels, "CUDA_HOME_DEFAULT", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.library("histogram")
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.build()
    assert not (tmp_path / "build").exists()


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(200, 3)
    return X, (X[:, 0] > 0).astype(float)


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data()
    assert Config({}).device_type == "cuda"
    assert Config({"device": "gpu"}).device_type == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        lgt.train({"objective": "binary"}, lgt.Dataset(X, y), 1)
    with pytest.raises(RuntimeError, match="cuda"):
        lgt.Dataset(X, y).construct()
    with pytest.raises(RuntimeError, match="cuda"):
        lgt.train({"objective": "binary", "device_type": "gpu"},
                  lgt.Dataset(X, y, params={"device_type": "cpu"}), 1)


@pytest.mark.parametrize("device", ["tpu", "cuda:7x", "mps"])
def test_unknown_device_raises(device):
    with pytest.raises(ValueError, match="device_type"):
        Config({"device_type": device})


@pytest.mark.parametrize("params", [
    {"objective": "regression_l1"},
    {"objective": "quantile", "alpha": 0.25},
    {"objective": "mape"},
    {"objective": "lambdarank", "eval_at": [2, 4]},
    {"objective": "rank_xendcg"},
    {"objective": "multiclass", "num_class": 2, "metric": "auc_mu"},
])
def test_parameters_of_the_ranking_and_renewal_slice_train(params):
    """What raised naming ROADMAP A12b until it was ported trains one round
    on the CPU, and the parameter takes effect."""
    X, y = _data()
    group = [50, 50, 100]
    p = dict({"device_type": "cpu", "verbosity": -1, "num_leaves": 4,
              "min_data_in_leaf": 5}, **params)
    ds = lgt.Dataset(X, y, group=group)
    bst = lgt.train(p, ds, 1, valid_sets=[ds], valid_names=["train"])
    obj = bst._gbdt.objective
    assert bst.num_trees() == (2 if "num_class" in params else 1)
    names = [m for _, m, _, _ in bst.eval_train()]
    text = bst.model_to_string()
    name = params["objective"]
    assert f"objective={name}" in text
    if name in ("regression_l1", "quantile", "mape"):
        # leaf renewal: each leaf's output is its rows' weighted quantile of
        # the residuals, shrunk (learning rate 0.1, boost from the mean)
        assert obj.renew_leaves
        tree = bst._gbdt.models[0]
        leaf = tree.leaf_value[:tree.num_leaves]
        res = y - float(np.mean(y))
        assert np.all(np.abs(leaf - np.mean(y)) <= 0.1 * np.abs(res).max()
                      + 1e-6)
    if name == "quantile":
        assert "alpha:0.25" in text and obj.renew_alpha == 0.25
    if name == "mape":
        np.testing.assert_allclose(obj.weight, 1.0 / np.maximum(1.0, y))
    if name == "lambdarank":
        # 200 rows take the masked grower; the compact route is open to it
        assert names == ["ndcg@2", "ndcg@4"] and bst._gbdt._ext_grads
    if name == "rank_xendcg":
        assert names == ["ndcg@1", "ndcg@2", "ndcg@3", "ndcg@4", "ndcg@5"]
        assert obj.is_stochastic and not bst._gbdt.use_compact
    if params.get("metric") == "auc_mu":
        assert names == ["auc_mu"]


@pytest.mark.parametrize("params,item", [
    ({"tree_learner": "data"}, "A18"),
    ({"tpu_checkpoint_dir": "ckpt"}, "A16"),
    ({"deterministic": True}, "B1/B2"),
    ({"num_machines": 2}, "A18"),
    ({"two_round": True}, "A16"),
    ({"snapshot_freq": 2}, "A16"),
    ({"save_period": 5}, "A16"),
    ({"top_k": 30}, "A18"),
    ({"tpu_leaf_quant": "int8"}, "A17"),
    ({"header": True}, "A16"),
])
def test_parameters_outside_the_slice_raise(params, item):
    X, y = _data()
    p = dict({"objective": "binary", "device_type": "cpu",
              "verbosity": -1}, **params)
    with pytest.raises(NotImplementedError, match=item):
        lgt.train(p, lgt.Dataset(X, y), 1)


@pytest.mark.parametrize("value,fused", [
    ("auto", True), ("on", True), ("off", False), ("sideways", True)])
def test_tpu_fused_is_read(value, fused):
    """``tpu_fused`` (once an ignored key; ROADMAP A7c) is in ``PARAMS``:
    off trains the compact grower without the fused kernel, an unknown
    value warns and means auto, as the JAX package's
    ``resolve_fused_block`` does; ``tpu_bin_pack4`` is accepted."""
    from lightgbm_tpu_torch.config import resolve_fused
    assert "tpu_fused" in PARAMS and "tpu_fused" not in IGNORED_PARAMS
    assert "tpu_fused_block" in IGNORED_PARAMS
    cfg = Config({"tpu_fused": value, "tpu_bin_pack4": True})
    cfg.check_supported()
    assert resolve_fused(cfg) is fused
    X, y = _data()
    bst = lgt.train({"objective": "binary", "device_type": "cpu",
                     "verbosity": -1, "tpu_grower": "compact",
                     "tpu_fused": value, "num_leaves": 4},
                    lgt.Dataset(X, y), 1)
    assert bst._gbdt.grower_params.fused is fused


@pytest.mark.parametrize("params", [
    {"pred_early_stop": True, "pred_early_stop_margin": 0.5,
     "pred_early_stop_freq": 1},
    {"refit_decay_rate": 0.5}])
def test_prediction_parameters_take_effect(params):
    """``pred_early_stop`` and ``refit_decay_rate`` (refused until the
    twelfth slice, ROADMAP A10 and A8) act as the reference's do: early
    stopped binary predictions, and refit's default decay (parity with the
    JAX package in tests/test_torch_predict_api.py)."""
    X, y = _data()
    p = dict({"objective": "binary", "device_type": "cpu",
              "verbosity": -1}, **params)
    bst = lgt.train(p, lgt.Dataset(X, y), 4)
    plain = bst.predict(X, pred_early_stop=False)
    if "pred_early_stop" in params:
        assert np.abs(bst.predict(X) - plain).max() > 1e-4
        return
    np.testing.assert_array_equal(bst.predict(X), plain)
    by_param = bst.refit(X, y)._gbdt.models
    explicit = bst.refit(X, y, decay_rate=0.5)._gbdt.models
    default = bst.refit(X, y, decay_rate=0.9)._gbdt.models
    for a, b, c in zip(by_param, explicit, default):
        np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    assert any(np.abs(a.leaf_value - c.leaf_value).max() > 1e-6
               for a, c in zip(by_param, default))


@pytest.mark.parametrize("params", [
    {"extra_trees": True},
    {"monotone_constraints": [1, 0, 0]},
    {"monotone_constraints": "1,0,-1", "monotone_penalty": 1.0,
     "monotone_constraints_method": "intermediate"},
    {"interaction_constraints": [[0, 1]]},
    {"interaction_constraints": "[0,1],[1,2]"},
    {"cegb_penalty_split": 0.1},
    {"cegb_penalty_feature_coupled": [1.0, 0.0, 2.0]},
    {"cegb_penalty_feature_lazy": "0.1,0.1,0.1"},
    {"path_smooth": 0.5},
    {"feature_contri": [1.0, 0.5, 1.0]},
], ids=["extra_trees", "monotone", "monotone_intermediate", "interaction",
        "interaction_string", "cegb_split", "cegb_coupled", "cegb_lazy",
        "path_smooth", "feature_contri"])
def test_split_options_train(params):
    """The options of the tenth slice (ROADMAP A14b) train; their parity
    with the JAX package is in tests/test_torch_constraints.py."""
    X, y = _data()
    p = dict({"objective": "binary", "device_type": "cpu",
              "verbosity": -1}, **params)
    bst = lgt.train(p, lgt.Dataset(X, y), 2)
    assert bst.num_trees() == 2
    assert np.all(np.isfinite(bst.predict(X)))


@pytest.mark.parametrize("value", [True, "true", False])
def test_enable_bundle_trains(value):
    """``enable_bundle`` is LightGBM's default (True) in the port too, and
    written out either way it trains (EFB, ROADMAP A13)."""
    assert Config({}).enable_bundle is True
    assert Config({}).max_conflict_rate == 1e-4
    X, y = _data()
    bst = lgt.train({"objective": "binary", "device_type": "cpu",
                     "verbosity": -1, "enable_bundle": value,
                     "max_conflict_rate": 0.0}, lgt.Dataset(X, y), 2)
    assert bst.num_trees() == 2
    assert np.all(np.isfinite(bst.predict(X)))


def _reference_params():
    """The JAX package's ``PARAMS`` (name -> (default, type, aliases)), read
    from ``lightgbm_tpu/config.py`` as a file with ``ast``: no import."""
    import ast
    tree = ast.parse(open(os.path.join(ROOT, "lightgbm_tpu",
                                       "config.py")).read())
    for node in tree.body:
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  else getattr(node, "target", None))
        if getattr(target, "id", None) == "PARAMS":
            return {ast.literal_eval(k): (ast.literal_eval(v.elts[0]),
                                          v.elts[1].id,
                                          ast.literal_eval(v.elts[2]))
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no PARAMS in lightgbm_tpu/config.py")


def test_every_reference_parameter_has_a_place():
    """Each key of the JAX package's ``PARAMS`` is read by the port, refused
    away from its default (naming its ROADMAP item) or ignored as changing
    no result: none is dropped unseen. The refused keys keep the
    reference's defaults and aliases."""
    from lightgbm_tpu_torch.config import (IGNORED_PARAMS, PARAMS,
                                           REFUSED_PARAMS)
    ref = _reference_params()
    assert len(ref) > 150
    homes = [set(PARAMS), set(REFUSED_PARAMS), set(IGNORED_PARAMS)]
    for name in ref:
        assert sum(name in h for h in homes) == 1, name
    for name, (default, _typ, aliases, item) in REFUSED_PARAMS.items():
        assert default == ref[name][0] and aliases == ref[name][2], name
        assert re.fullmatch(r"A\d+[a-z]?", item), name
    for name, aliases in IGNORED_PARAMS.items():
        assert aliases == ref[name][2], name
    for name in ("drop_rate", "max_drop", "skip_drop", "uniform_drop",
                 "xgboost_dart_mode", "drop_seed", "linear_lambda",
                 "start_iteration_predict", "num_iteration_predict"):
        assert PARAMS[name][0] == ref[name][0], name
        assert PARAMS[name][2] == ref[name][2], name


def test_parameter_homes_act():
    """A DART key is read (not dropped), a refused key set to its default
    passes, an ignored key is accepted quietly, an unknown key warns."""
    cfg = Config({"rate_drop": 0.5, "top_k": 20, "tpu_fused": "off",
                  "label": ""})
    assert cfg.drop_rate == 0.5
    cfg.check_supported()
    with pytest.raises(NotImplementedError, match="A18"):
        Config({"topk": 21}).check_supported()
    with pytest.raises(NotImplementedError, match="A16"):
        Config({"label": "name:y"}).check_supported(dataset_only=True)
    import logging
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("lightgbm_tpu_torch")
    logger.addHandler(handler)
    try:
        Config({"tpu_step_buckets": "off", "no_such_key": 1})
    finally:
        logger.removeHandler(handler)
    assert any("Unknown parameter: no_such_key" in m for m in seen)
    assert not any("tpu_step_buckets" in m and "Unknown" in m for m in seen)
