"""Rules of the PyTorch port (lightgbm_tpu_torch), checked on the CPU.

* the port never loads JAX or the JAX package, and its sources (and
  chip_smoke.py) never import them;
* every module of the port imports on a machine without a card or nvcc;
  the kernel library is built at first use and, without nvcc, that call
  raises a clear RuntimeError;
* the device is explicit: ``cuda`` (the default) without a card raises,
  never falling back to the CPU; unknown devices raise;
* parameters outside the port's slice raise NotImplementedError naming the
  ROADMAP item that brings them.
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
from lightgbm_tpu_torch.config import Config

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


@pytest.mark.parametrize("params,item", [
    ({"objective": "regression"}, "A12"),
    ({"num_class": 3, "objective": "multiclass"}, "A12"),
    ({"categorical_feature": [0]}, "A12"),
    ({"tree_learner": "data"}, "A18"),
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, "A14"),
    ({"boosting": "goss"}, "A14"),
    ({"feature_fraction": 0.5}, "A14"),
    ({"feature_fraction_bynode": 0.5}, "A14"),
    ({"extra_trees": True}, "A14"),
    ({"monotone_constraints": [1, 0, 0]}, "A14"),
    ({"interaction_constraints": [[0, 1]]}, "A14"),
    ({"cegb_penalty_split": 0.1}, "A14"),
    ({"forcedsplits_filename": "f.json"}, "A14"),
    ({"linear_tree": True}, "A14"),
    ({"enable_bundle": True}, "A13"),
    ({"use_quantized_grad": True}, "A15"),
    ({"tpu_bin_pack4": True}, "A15"),
    ({"tpu_grower": "masked"}, "A11"),
    ({"tpu_hist_layout": "sublane"}, "B3"),
    ({"deterministic": True}, "B1/B2"),
    ({"feature_contri": [1.0, 0.5, 1.0]}, "A14"),
    ({"num_machines": 2}, "A18"),
    ({"input_model": "model.txt"}, "A9"),
    ({"boosting": "dart"}, "A14"),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
     "A14"),
])
def test_parameters_outside_the_slice_raise(params, item):
    X, y = _data()
    p = dict({"objective": "binary", "device_type": "cpu",
              "verbosity": -1}, **params)
    with pytest.raises(NotImplementedError, match=item):
        lgt.train(p, lgt.Dataset(X, y), 1)
