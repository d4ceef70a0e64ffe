"""Learning to rank in the port (``lambdarank``, ``rank_xendcg``, query
groups, the ranking metrics) against the JAX package, on the CPU
(``device_type="cpu"``, the plain versions of the kernels).

* the lambdarank gradients equal the JAX objective's (1e-6) on tied scores
  (the first iteration: every score 0, so the stable sort's document order
  is the gradient), random scores, ``lambdarank_norm`` off, a custom
  ``label_gain``, a truncation level below the query length, row weights,
  and over two calls with ``position`` (the position-bias update);
* the XENDCG gradients with the JAX package's gamma draws fed through the
  ``draws`` seam;
* ``train``: lambdarank on the compact grower (external gradients: scores
  scattered back by the carried row id, gradients gathered into the
  records' order) equals the JAX package's trees split for split against
  both oracles (``tpu_fused=off`` and the fused kernel in interpret mode),
  predictions within 1e-6 and the same validation ndcg@k; lambdarank with
  ``position`` and XENDCG (the JAX draws) on the masked grower;
* the grower each ranking configuration takes is the JAX package's;
* ``ndcg``, ``map``, ``auc_mu``, ``average_precision`` and ``kldiv`` equal
  the JAX metrics within 1e-9;
* port-written ranking text loads into the JAX package and predicts the
  same; ``Dataset`` group and position handling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
from lightgbm_tpu.metrics import create_metric as jax_create_metric
from lightgbm_tpu.objectives import create_objective as jax_create_objective
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.objectives import RankXENDCG, create_objective

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)


def _queries(nq, seed, lo=3, hi=40):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(lo, hi, nq)
    n = int(sizes.sum())
    X = rng.randn(n, 6)
    X[::13, 2] = np.nan
    rel = X[:, 0] - 0.5 * X[:, 1] + 0.6 * rng.randn(n)
    y = np.digitize(rel, np.quantile(rel, [0.5, 0.75, 0.9, 0.97]))
    pos = np.concatenate([np.arange(s) for s in sizes])
    return X, y.astype(np.float64), sizes, pos


def _objectives(name, params, y, sizes, weight=None, pos=None):
    n = len(y)
    p = dict(params, objective=name)
    port = create_objective(Config(p).objective, Config(p))
    ref = jax_create_objective(name, JaxConfig(p))
    md, jmd = Metadata(n), JaxMetadata(n)
    for m in (md, jmd):
        m.set_label(y)
        m.set_weight(weight)
        m.set_group(sizes)
        m.set_position(pos)
    port.init(md, n)
    ref.init(jmd, n)
    return port, ref


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("case", ["tied", "random", "norm_off",
                                  "label_gain", "truncation", "weighted"])
def test_lambdarank_gradients_match_jax(case):
    _, y, sizes, _ = _queries(30, seed=1)
    rng = np.random.RandomState(2)
    n = len(y)
    params = {}
    weight = None
    score = rng.randn(n).astype(np.float32)
    if case == "tied":
        score[:] = 0.0
    elif case == "norm_off":
        params["lambdarank_norm"] = False
    elif case == "label_gain":
        params["label_gain"] = [0.0, 1.0, 3.0, 4.0, 10.0]
    elif case == "truncation":
        params["lambdarank_truncation_level"] = 3
    elif case == "weighted":
        weight = (rng.rand(n) + 0.5).astype(np.float32)
    port, ref = _objectives("lambdarank", params, y, sizes, weight)
    g, h = port.get_gradients(torch.from_numpy(score))
    rg, rh = ref.get_gradients(jnp.asarray(score))
    _close(g, rg, "grad")
    _close(h, rh, "hess")
    assert float(torch.abs(g).sum()) > 0
    if case == "tied":
        # a tie sorts in document order: the first document of a query
        # whose labels differ is ranked first
        assert not np.allclose(np.asarray(rg)[:sizes[0]], 0.0)


def test_lambdarank_position_bias_over_two_calls():
    _, y, sizes, pos = _queries(30, seed=3)
    port, ref = _objectives("lambdarank", {"learning_rate": 0.3,
                            "lambdarank_position_bias_regularization": 0.1},
                            y, sizes, pos=pos)
    assert port.is_stochastic and ref.is_stochastic
    rng = np.random.RandomState(4)
    for _ in range(2):
        score = rng.randn(len(y)).astype(np.float32)
        g, h = port.get_gradients(torch.from_numpy(score))
        rg, rh = ref.get_gradients(jnp.asarray(score))
        _close(g, rg, "grad")
        _close(h, rh, "hess")
        _close(port.pos_biases, ref.pos_biases, "position biases")
    assert float(torch.abs(port.pos_biases).max()) > 0


def _jax_xendcg_draws(seed, calls, shape):
    """The gamma(1) draws of the JAX objective's first ``calls`` calls."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(calls):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gamma(sub, 1.0, shape=shape)))
    return out


def test_xendcg_gradients_match_jax_with_its_draws():
    _, y, sizes, _ = _queries(30, seed=5)
    weight = np.random.RandomState(6).rand(len(y)).astype(np.float32) + 0.5
    port, ref = _objectives("rank_xendcg", {}, y, sizes, weight)
    draws = _jax_xendcg_draws(5, 2, (len(sizes), int(sizes.max())))
    rng = np.random.RandomState(7)
    for d in draws:
        score = rng.randn(len(y)).astype(np.float32)
        g, h = port.get_gradients(torch.from_numpy(score),
                                  draws=torch.from_numpy(d))
        rg, rh = ref.get_gradients(jnp.asarray(score))
        _close(g, rg, "grad")
        _close(h, rh, "hess")
    # its own draws: the same shape of gradient, a new draw each call
    g1, _ = port.get_gradients(torch.from_numpy(score))
    g2, _ = port.get_gradients(torch.from_numpy(score))
    assert g1.shape == (len(y),) and not torch.equal(g1, g2)


def test_ranking_objective_takes_scores_only():
    """The compact grower's permuted label and weight columns must never
    reach a row-coupled objective."""
    _, y, sizes, _ = _queries(5, seed=8)
    port, _ = _objectives("lambdarank", {}, y, sizes)
    s = torch.zeros(len(y))
    with pytest.raises(ValueError, match="scores only"):
        port.get_gradients(s, torch.from_numpy(y).float())


@pytest.fixture
def jax_xendcg_draws(monkeypatch):
    """Feed the port's XENDCG the JAX objective's draws, call by call."""
    state = {"key": jax.random.PRNGKey(5)}

    def draws(self, shape, device):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gamma(
            sub, 1.0, shape=tuple(shape)))).to(device)
    monkeypatch.setattr(RankXENDCG, "_draws", draws)
    return state


def _assert_same_trees(tj, tt, atol=1e-6, rtol=0.0):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n
        for k in ("split_feature", "split_bin", "default_left",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, k)[:n],
                                          np.asarray(getattr(a, k))[:n], k)
        np.testing.assert_allclose(b.leaf_value[:n + 1],
                                   np.asarray(a.leaf_value)[:n + 1],
                                   rtol=rtol, atol=atol)


RANK = {"objective": "lambdarank", "num_leaves": 7, "min_data_in_leaf": 10,
        "metric": "ndcg,map", "eval_at": [3, 10], "verbosity": -1}


@pytest.mark.parametrize("oracle", ["xla", "fused_interpret"])
def test_lambdarank_compact_matches_jax(oracle):
    X, y, sizes, _ = _queries(80 if oracle == "xla" else 60, seed=9)
    Xv, yv, sv, _ = _queries(12, seed=10)
    rounds = 3 if oracle == "xla" else 2
    p = dict(RANK, tpu_grower="compact")
    jp = dict(p, tpu_fused="off") if oracle == "xla" else dict(
        p, tpu_fused_interpret=True, tpu_fused_block=128)
    jev, tev = {}, {}
    jds = lgb.Dataset(X, label=y, group=sizes)
    bj = lgb.train(jp, jds, rounds,
                   valid_sets=[jds.create_valid(Xv, label=yv, group=sv)],
                   callbacks=[lgb.record_evaluation(jev)])
    _kernels.reset_counts()
    tds = lgt.Dataset(X, y, group=sizes)
    bt = lgt.train(dict(p, device_type="cpu"), tds, rounds,
                   valid_sets=[tds.create_valid(Xv, yv, group=sv)],
                   callbacks=[lgt.record_evaluation(tev)])
    g = bt._gbdt
    assert g.use_compact and g._ext_grads and bj._gbdt._use_compact
    assert sum(_kernels.LAUNCHES.values()) == 0
    # the first tree grows from tied scores (no boost from average)
    assert bt._gbdt._init_scores == [0.0]
    _assert_same_trees(bj._gbdt.models, g.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-6)
    assert list(tev["valid_0"]) == list(jev["valid_0"]) == [
        "ndcg@3", "ndcg@10", "map@3", "map@10"]
    for m, vals in jev["valid_0"].items():
        np.testing.assert_allclose(tev["valid_0"][m], vals, rtol=1e-9)
    # the carried train scores, back in dataset order, are the predictions
    np.testing.assert_allclose(g.train_score_original_order()[0],
                               bt.predict(X, raw_score=True), atol=1e-5)


@pytest.mark.parametrize("case", ["xendcg", "position", "auto_small"])
def test_ranking_masked_matches_jax(case, jax_xendcg_draws):
    X, y, sizes, pos = _queries(60, seed=11)
    p = dict(RANK, min_data_in_leaf=20, tpu_grower="masked")
    kw = {}
    if case == "xendcg":
        p["objective"] = "rank_xendcg"
    elif case == "position":
        kw["position"] = pos
    else:
        p["tpu_grower"] = "auto"
    bj = lgb.train(p, lgb.Dataset(X, label=y, group=sizes, **kw), 3)
    jax_xendcg_draws["key"] = jax.random.PRNGKey(5)
    bt = lgt.train(dict(p, device_type="cpu"),
                   lgt.Dataset(X, y, group=sizes, **kw), 3)
    assert not bt._gbdt.use_compact and not bj._gbdt._use_compact
    # XENDCG: the two libraries' f32 softmaxes differ by an ulp (1.2e-7 in
    # a gradient, test_xendcg_gradients_match_jax_with_its_draws), and a
    # leaf's gradient sum cancels (each query's gradients sum to 0), so its
    # output carries a relative error of about 1e-5 a tree
    rtol = 5e-5 if case == "xendcg" else 0.0
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models, rtol=rtol)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=rtol,
                               atol=1e-6)
    if case == "position":
        np.testing.assert_allclose(
            bt._gbdt.objective.pos_biases.numpy(),
            np.asarray(bj._gbdt.objective.pos_biases), atol=1e-6)


@pytest.mark.parametrize("params,compact", [
    ({"objective": "lambdarank"}, True),
    ({"objective": "rank_xendcg"}, False),
    ({"objective": "lambdarank", "use_quantized_grad": True}, False),
    ({"objective": "lambdarank", "position": True}, True),
    ({"objective": "lambdarank", "tpu_grower": "auto"}, False),
    ({"objective": "regression"}, True),
])
def test_ranking_grower_choice_matches_jax(params, compact):
    """The grower of each configuration is the JAX package's: a row-coupled
    objective takes the compact grower with one tree a round, no
    quantized gradients and no random draws. Lambdarank with ``position``
    takes it too: the reference decides before its objective's init,
    which is what marks it stochastic."""
    X, y, sizes, pos = _queries(40, seed=12)
    p = dict({"num_leaves": 4, "verbosity": -1, "tpu_grower": "compact",
              "tpu_fused": "off"}, **params)
    kw = {"position": pos} if p.pop("position", False) else {}
    bj = lgb.train(p, lgb.Dataset(X, label=y, group=sizes, **kw), 1)
    p.pop("tpu_fused")
    bt = lgt.train(dict(p, device_type="cpu"),
                   lgt.Dataset(X, y, group=sizes, **kw), 1)
    assert bt._gbdt.use_compact == bj._gbdt._use_compact == compact


def test_ranking_data_is_not_bundled():
    """One-hot-wide ranking data: the JAX package unbundles it (query
    groups keep the bundle-space grower out), and so does the port."""
    rng = np.random.RandomState(13)
    n, blocks = 1200, 40
    X = np.zeros((n, blocks * 8))
    X[np.arange(n)[:, None], np.arange(blocks) * 8
      + rng.randint(0, 8, (n, blocks))] = 1.0
    y = rng.randint(0, 3, n).astype(float)
    sizes = np.full(30, 40)
    p = {"objective": "lambdarank", "num_leaves": 4, "verbosity": -1}
    bj = lgb.train(p, lgb.Dataset(X, label=y, group=sizes), 1)
    ds = lgt.Dataset(X, y, group=sizes, params={"device_type": "cpu"})
    ds.construct()
    assert ds._inner.bundle_info is not None
    bt = lgt.train(dict(p, device_type="cpu"), ds, 1)
    assert ds._inner.bundle_info is None and bt._gbdt._efb is None
    assert bj._gbdt.train_set.bundle_info is None
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


@pytest.mark.parametrize("metric,kw", [
    ("ndcg", {"eval_at": [1, 3, 5, 20]}),
    ("ndcg", {"eval_at": [2, 10], "label_gain": [0, 1, 2, 5, 9]}),
    ("map", {"eval_at": [1, 4, 30]}),
    ("auc_mu", {"num_class": 4}),
    ("auc_mu", {"num_class": 3, "auc_mu_weights": [0, 1, 2, 1, 0, 3, 2,
                                                   3, 0]}),
    ("average_precision", {}),
    ("kldiv", {}),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_metric_matches_jax(metric, kw, weighted):
    _, y, sizes, _ = _queries(25, seed=14)
    rng = np.random.RandomState(15)
    n = len(y)
    k = kw.get("num_class", 1)
    if metric == "auc_mu":
        y = rng.randint(0, k, n).astype(np.float64)
        raw = rng.randn(k, n)
    else:
        raw = np.round(rng.randn(n), 1)              # tied scores
    if metric in ("average_precision", "kldiv"):
        y = (rng.rand(n) < 0.3).astype(np.float64) if metric != "kldiv" \
            else rng.rand(n)
    weight = (rng.rand(n) + 0.5) if weighted else None
    params = dict(kw, objective="multiclass" if k > 1 else "binary")
    port = create_metrics([metric], Config(params))[0]
    ref = jax_create_metric(metric, JaxConfig(params))
    md, jmd = Metadata(n), JaxMetadata(n)
    for m in (md, jmd):
        m.set_label(y)
        m.set_weight(weight)
        m.set_group(sizes)
    port.init(md, n)
    ref.init(jmd, n)
    assert port.higher_better == ref.higher_better
    if hasattr(ref, "eval_all"):
        np.testing.assert_allclose(port.eval_all(raw), ref.eval_all(raw),
                                   rtol=0, atol=1e-9)
        assert port.eval_at == ref.eval_at
    else:
        sig = (lambda r: 1.0 / (1.0 + np.exp(-r)))
        assert port.eval(raw, sig) == pytest.approx(ref.eval(raw, sig),
                                                    rel=0, abs=1e-9)


def test_ranking_text_loads_in_jax_and_back(tmp_path):
    X, y, sizes, _ = _queries(40, seed=16)
    bt = lgt.train(dict(RANK, device_type="cpu"),
                   lgt.Dataset(X, y, group=sizes), 4)
    path = tmp_path / "rank.txt"
    bt.save_model(str(path))
    text = path.read_text()
    assert "objective=lambdarank" in text
    p = bt.predict(X)
    np.testing.assert_allclose(lgt.Booster(model_file=str(path)).predict(X),
                               p, atol=1e-6)
    np.testing.assert_allclose(lgb.Booster(model_str=text).predict(X), p,
                               atol=1e-6)


def test_dataset_groups():
    X, y, sizes, pos = _queries(10, seed=17)
    cpu = {"device_type": "cpu"}
    ds = lgt.Dataset(X, y, group=sizes, position=pos, params=cpu)
    assert ds.get_group() is sizes
    ds.construct()
    md = ds._inner.metadata
    np.testing.assert_array_equal(ds.get_group(), sizes)
    np.testing.assert_array_equal(md.query_boundaries,
                                  np.concatenate([[0], np.cumsum(sizes)]))
    assert md.num_queries == 10
    np.testing.assert_array_equal(md.position, pos)
    dv = ds.create_valid(X[:30], y[:30], group=[10, 20])
    dv.construct()
    np.testing.assert_array_equal(dv._inner.metadata.query_boundaries,
                                  [0, 10, 30])
    with pytest.raises(ValueError, match="group"):
        lgt.Dataset(X, y, group=sizes[:-1], params=cpu).construct()
    ds.set_group(None)
    assert md.query_boundaries is None
    with pytest.raises(ValueError, match="query groups"):
        lgt.train({"objective": "lambdarank", "device_type": "cpu",
                   "verbosity": -1}, lgt.Dataset(X, y), 1)
