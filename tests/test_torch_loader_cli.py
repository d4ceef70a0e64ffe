"""The text-file loader and the command line of the port on the CPU, held
against the JAX package's: ``load_text_file`` on CSV, TSV with a header
and ``name:`` columns, LibSVM, the ``.weight``/``.query`` sidecar files,
``ignore_column``, ``two_round`` and a registered parser (arrays equal);
``python -m lightgbm_tpu_torch`` tasks ``train`` (LightGBM's
``examples/binary_classification/train.conf`` keys; trees equal to the
JAX CLI's, snapshots equal to ``model_to_string(num_iteration=N)``),
``predict`` (``Booster(model_file=...).predict`` within 1e-6),
``save_binary``, ``refit`` and ``convert_model`` (the if-else text equal).
"""
import json
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import cli as jcli
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.io import loader as jloader
from lightgbm_tpu.model_io import LoadedGBDT as JaxLoaded
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.io import loader as tloader
from lightgbm_tpu_torch.model_io import LoadedGBDT

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

_rng = np.random.RandomState(7)
X = np.round(_rng.randn(2000, 6), 4)
X[_rng.rand(2000) < 0.03, 2] = np.nan
Y = (X[:, 0] - 0.4 * X[:, 1] + 0.3 * _rng.randn(2000) > 0).astype(float)
W = np.round(_rng.uniform(0.5, 1.5, 2000), 3)
QID = np.repeat(np.arange(100), 20)

# LightGBM's examples/binary_classification/train.conf, cut to 3 trees
TRAIN_CONF = """\
task = train
boosting_type = gbdt
objective = binary
metric = binary_logloss,auc
metric_freq = 1
is_training_metric = true
max_bin = 255
num_trees = 3
learning_rate = 0.1
num_leaves = 63
tree_learner = serial
feature_fraction = 0.8
bagging_freq = 5
bagging_fraction = 0.8
min_data_in_leaf = 50
min_sum_hessian_in_leaf = 5.0
is_enable_sparse = true
use_two_round_loading = false
is_save_binary_file = false
header = true
label_column = name:label
verbosity = -1
"""


def write_csv(path, delim=",", header=True, meta=True):
    """The rows as text: the label, with ``meta`` a weight and a query id
    column, then the features."""
    cols = ["label"] + (["w", "qid"] if meta else []) \
        + [f"x{j}" for j in range(X.shape[1])]
    table = np.column_stack([Y, W, QID, X] if meta else [Y, X])
    with open(path, "w") as fh:
        if header:
            fh.write(delim.join(cols) + "\n")
        for row in table:
            fh.write(delim.join("" if np.isnan(v) else repr(float(v))
                                for v in row) + "\n")
    return str(path)


def assert_same_load(a, b):
    for va, vb, name in zip(a, b, ("X", "label", "weight", "group",
                                   "names")):
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(vb, va, err_msg=name)
        else:
            assert vb == va, name


@pytest.mark.parametrize("case", ["csv", "tsv_header_names", "libsvm",
                                  "ignore_column"])
def test_load_text_file_matches_jax(case, tmp_path):
    if case == "libsvm":
        path = str(tmp_path / "data.svm")
        with open(path, "w") as fh:
            for y, row in zip(Y[:300], X[:300]):
                fh.write(f"{int(y)} " + " ".join(
                    f"{j}:{float(v)!r}" for j, v in enumerate(row)
                    if v != 0 and not np.isnan(v)) + "\n")
        kw = {}
    elif case == "csv":
        path = write_csv(tmp_path / "data.csv", header=False)
        kw = {"label_column": "0", "weight_column": "1",
              "group_column": "2"}
    elif case == "tsv_header_names":
        path = write_csv(tmp_path / "data.tsv", delim="\t")
        kw = {"has_header": True, "label_column": "name:label",
              "weight_column": "name:w", "group_column": "name:qid"}
    else:
        path = write_csv(tmp_path / "data.csv")
        kw = {"has_header": True, "ignore_column": "1,2,name:x3"}
    got = tloader.load_text_file(path, **kw)
    assert_same_load(jloader.load_text_file(path, **kw), got)
    if case == "tsv_header_names":
        assert got[4] == [f"x{j}" for j in range(6)]
        np.testing.assert_array_equal(got[3], np.full(100, 20))
    if case == "ignore_column":
        assert got[0].shape == (2000, 5) and "x3" not in got[4]


def test_sidecar_files(tmp_path):
    path = write_csv(tmp_path / "rank.csv")
    np.savetxt(path + ".weight", W)
    np.savetxt(path + ".query", np.full(100, 20), fmt="%d")
    for fn in ("load_weight_file", "load_query_file"):
        np.testing.assert_array_equal(getattr(tloader, fn)(path),
                                      getattr(jloader, fn)(path))
    assert tloader.load_weight_file(str(tmp_path / "none.csv")) is None


def test_two_round_streams_rows(tmp_path):
    """The first pass keeps offsets and metadata; the rows bin through the
    Sequence path into the same bins as the JAX package's."""
    path = write_csv(tmp_path / "data.csv")
    kw = {"has_header": True, "label_column": "name:label",
          "weight_column": "name:w", "two_round": True}
    jx, *jrest = jloader.load_text_file(path, **kw)
    tx, *trest = tloader.load_text_file(path, **kw)
    assert isinstance(tx, lgt.Sequence) and len(tx) == 2000
    np.testing.assert_array_equal(tx[0:2000], jx[0:2000])
    np.testing.assert_array_equal(tx[17], jx[17])
    for a, b in zip(jrest, trest):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    dt = lgt.Dataset(tx, trest[0], weight=trest[1],
                     params={"device_type": "cpu"}).construct()
    dj = lgb.Dataset(jx, label=jrest[0], weight=jrest[1]).construct()
    np.testing.assert_array_equal(dt._inner.binned, dj._inner.binned)


def test_registered_parser(tmp_path):
    path = str(tmp_path / "data.txt")
    with open(path, "w") as fh:
        for y, w, row in zip(Y[:200], W[:200], X[:200]):
            fh.write(f"{y}|{w}|"
                     + ";".join(repr(float(v)) for v in row) + "\n")
    conf = str(tmp_path / "parser.json")
    with open(conf, "w") as fh:
        json.dump({"className": "pipes"}, fh)

    def parse(line):
        y, w, rest = line.split("|")
        return [float(w)] + [float(v) for v in rest.split(";")], float(y)
    lgb.register_parser("pipes", parse)
    lgt.register_parser("pipes", parse)
    kw = {"parser_config_file": conf, "weight_column": "0"}
    got = tloader.load_text_file(path, **kw)
    assert_same_load(jloader.load_text_file(path, **kw), got)
    np.testing.assert_array_equal(got[2], W[:200])


@pytest.fixture
def same_bags(monkeypatch):
    """The port's bags from the JAX package's draws (``PRNGKey(seed)``)."""
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = lambda seed, size: torch.from_numpy(
            np.array(jax.random.uniform(jax.random.PRNGKey(seed), (size,))))
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


@pytest.fixture
def dyadic(monkeypatch):
    """Binary gradients and hessians on a 1/64 grid in both packages: the
    histogram sums are exact, so two splits of equal gain tie exactly and
    both packages take the first (on the run's own gradients, f32
    summation order picks between splits a few ulps apart)."""
    jg, tg = (jobj.BinaryLogloss.get_gradients,
              tobj.BinaryLogloss.get_gradients)

    def jround(self, score):
        g, h = jg(self, score)
        return jnp.round(g * 64) / 64, jnp.maximum(jnp.round(h * 64), 1) / 64

    def tround(self, score, label, weight=None):
        g, h = tg(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", jround)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", tround)


def trees_of(path):
    with open(path) as fh:
        return LoadedGBDT(fh.read()).models


def test_cli_tasks_match_jax(tmp_path, same_bags, dyadic, capsys):
    train = write_csv(tmp_path / "binary.train")
    test = write_csv(tmp_path / "binary.test")
    # the JAX CLI's predict and refit read no weight, query or ignored
    # column: their data holds the label and the features only
    plain = write_csv(tmp_path / "plain.csv", meta=False)
    conf = tmp_path / "train.conf"
    conf.write_text(TRAIN_CONF + "ignore_column = name:w,name:qid\n")
    out = {}
    for name, run, extra in (("jax", jcli.run, ["tpu_fused=off"]),
                             ("port", tcli.run, ["device_type=cpu"])):
        d = tmp_path / name
        d.mkdir()
        model = str(d / "model.txt")
        assert run([f"config={conf}", f"data={train}",
                    f"valid_data={test}", f"output_model={model}",
                    "snapshot_freq=1", *extra]) == 0
        assert run(["task=predict", f"data={plain}", f"input_model={model}",
                    "header=true", "label_column=name:label",
                    f"output_result={d / 'pred.txt'}", *extra]) == 0
        assert run(["task=refit", f"data={plain}", f"input_model={model}",
                    "header=true", "label_column=name:label",
                    f"output_model={d / 'refit.txt'}", *extra]) == 0
        assert run(["task=save_binary", f"data={train}", "header=true",
                    "label_column=name:label", "weight_column=name:w",
                    f"output_model={d / 'train.bin'}", *extra]) == 0
        assert run(["task=convert_model", f"input_model={model}",
                    f"convert_model={d / 'model.cpp'}"]) == 0
        out[name] = d
    jd, td = out["jax"], out["port"]
    # train: the same trees
    for a, b in zip(trees_of(jd / "model.txt"), trees_of(td / "model.txt"),
                    strict=True):
        for field in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(a, field), field)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, atol=1e-6)
    # snapshots: the text of the final model's first N iterations
    bst = lgt.Booster(model_file=str(td / "model.txt"))
    for n in (1, 2, 3):
        assert (jd / f"model.txt.snapshot_iter_{n}").exists()
        with open(td / f"model.txt.snapshot_iter_{n}") as fh:
            assert fh.read() == bst.model_to_string(num_iteration=n)
    # predict: Booster(model_file=...).predict, and the JAX CLI's
    pred = np.loadtxt(td / "pred.txt")
    Xt = tloader.load_text_file(test, has_header=True,
                                label_column="name:label",
                                ignore_column="name:w,name:qid")[0]
    np.testing.assert_array_equal(Xt, X)
    np.testing.assert_allclose(pred, bst.predict(Xt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pred, np.loadtxt(jd / "pred.txt"), rtol=0,
                               atol=1e-6)
    # refit, save_binary, convert_model
    np.testing.assert_allclose(
        lgt.Booster(model_file=str(td / "refit.txt")).predict(Xt),
        lgb.Booster(model_file=str(jd / "refit.txt")).predict(Xt), atol=1e-6)
    a = lgb.Dataset(str(jd / "train.bin")).construct()._inner
    b = lgt.Dataset(str(td / "train.bin"),
                    params={"device_type": "cpu"}).construct()._inner
    np.testing.assert_array_equal(b.binned, a.binned)
    np.testing.assert_array_equal(b.metadata.weight, a.metadata.weight)
    assert (td / "model.cpp").read_text() == (jd / "model.cpp").read_text()
    with open(jd / "model.txt") as fh:
        jtext = fh.read()
    assert LoadedGBDT(jtext).to_if_else() == JaxLoaded(jtext).to_if_else()
    # train and refit on the device asked for; predict (a loaded model) and
    # save_binary on the host, and the CLI says so
    said = capsys.readouterr().out
    assert "model saved to" in said and "(device cpu)" in said
    assert f"predictions saved to {td / 'pred.txt'} (on the host)" in said


def test_cli_needs_the_card_unless_told(tmp_path, monkeypatch):
    """``python -m lightgbm_tpu_torch`` (run here in process): the default
    device is the card (here absent, so the run raises); a missing
    argument and an unknown task exit 1."""
    data = write_csv(tmp_path / "d.csv")
    monkeypatch.setattr(sys, "argv", ["lightgbm_tpu_torch", f"data={data}",
                                      "header=true", "num_trees=1"])
    with pytest.raises(RuntimeError, match="device_type='cuda'"):
        runpy.run_module("lightgbm_tpu_torch", run_name="__main__")
    assert tcli.run(["task=predict", "device_type=cpu"]) == 1
    assert tcli.run(["task=nothing", "device_type=cpu"]) == 1
