"""The port's serving layer on the CPU: the ``Booster`` serving calls, the
server (coalescer, registry, hot swaps, typed errors), the reader-writer
lock, the drift monitor and the refusals.

* ``predict_serving``, ``predict_leaf_serving`` and
  ``predict_contrib_serving`` rows equal ``predict(float32(X))`` with
  ``pred_leaf`` and ``pred_contrib`` (bit for bit; contributions within
  1e-12 of a cell's scale), in both featurize modes and both engines, and
  ``predict_serving`` lies within 1e-6 of the JAX package's on trees
  trained equal (binary gradients on a 1/64 grid, the ``dyadic``
  fixture);
* a server's futures equal ``predict`` under mixed sizes from 4 threads,
  and a hot swap under load fails no request;
* ``ServingTimeout``, ``ServerOverloaded``, ``ServerClosed`` and
  ``SwapFailed`` come where they should (injected ``hang@coalesce_tick``
  and ``hang@swap`` faults), and a ``swap`` fault leaves the old version
  active;
* the drift monitor's PSI and KL equal the JAX package's on the same
  counts, and a shifted stream drifts where an unshifted one does not;
* the Prometheus endpoint, the drift records of ``tpu_metrics_path``
  (ROADMAP A19) and sharded prediction (A18) raise naming their item.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.obs import drift as jax_drift
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.analysis.faultinject import inject
from lightgbm_tpu_torch.obs import drift
from lightgbm_tpu_torch.ops.treeshap_device import build_shap_paths
from lightgbm_tpu_torch.serving import (PredictionServer, ServerClosed,
                                        ServerOverloaded, ServingTimeout,
                                        SwapFailed)
from lightgbm_tpu_torch.serving.cli import main as serve_cli
from lightgbm_tpu_torch.utils.rwlock import RWLock
from test_torch_constraints import dyadic  # noqa: F401

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "verbosity": -1, "device_type": "cpu",
        "tpu_predict_buckets": "64,256,1024",
        "tpu_serve_endpoints": "predict,leaf,contrib"}


def rows(n=1500, f=6, seed=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n) < 0.1, 2] = np.nan
    z = X[:, 0] + 0.5 * np.nan_to_num(X[:, 2]) ** 2 - 0.4 * X[:, 4] \
        + 0.3 * rng.randn(n)
    return X, z


_BOOSTERS = {}


def booster(rounds=5, **params):
    key = (rounds, tuple(sorted(params.items())))
    if key not in _BOOSTERS:
        X, z = rows()
        y = (z > 0.3).astype(np.float64)
        p = dict(BASE, **params)
        if p.get("objective") == "multiclass":
            y = np.digitize(z, [-0.3, 0.8]).astype(np.float64)
        _BOOSTERS[key] = lgt.train(p, lgt.Dataset(X, y), rounds)
    return _BOOSTERS[key]


def _contrib_close(ours, want, g):
    paths = build_shap_paths(g.models, g._pred_nan_arr.numpy(),
                             g.feature_is_categorical(), "cpu")
    scale = float(paths.leaf_value.abs().sum() + paths.ev.abs().sum())
    assert np.all(np.abs(ours - want) <= 1e-12 * (np.abs(want) + scale))


@pytest.mark.parametrize("params", [
    {},
    {"tpu_predict_engine": "level"},
    {"tpu_serve_featurize": "host"},
    {"objective": "multiclass", "num_class": 3, "num_iteration_predict": 2,
     "start_iteration_predict": 1},
    {"max_bin": 15, "tpu_bin_pack4": True, "tpu_predict_engine": "auto"},
    {"pred_early_stop": True, "pred_early_stop_margin": 0.5,
     "pred_early_stop_freq": 1}])
def test_serving_calls_equal_predict(params):
    """Each endpoint's rows ``[:n]`` against ``predict`` of the same float32
    rows, through the rung the batch pads to; ``predict_device`` too, above
    the ladder (slices of its top rung) as well."""
    bst = booster(**params)
    X, _ = rows()
    for n in (1, 63, 300):
        x = X[:n]
        out, m = bst.predict_serving(x)
        assert m == n and out.shape[0] == (64 if n <= 64 else 1024)
        np.testing.assert_array_equal(out[:n], bst.predict(x))
        raw, _ = bst.predict_serving(x, raw_score=True)
        np.testing.assert_array_equal(raw[:n], bst.predict(x,
                                                           raw_score=True))
        leaves, _ = bst.predict_leaf_serving(x)
        np.testing.assert_array_equal(leaves[:n],
                                      bst.predict(x, pred_leaf=True))
        _kernels.reset_counts()
        phi, _ = bst.predict_contrib_serving(x)
        assert _kernels.PLAIN_CALLS["treeshap"] == 1
        _contrib_close(phi[:n], bst.predict(x, pred_contrib=True),
                       bst._gbdt)
    dev = bst.predict_device(X)
    assert isinstance(dev, torch.Tensor) and len(dev) == len(X)
    # (predict_device does not stop early, as in the JAX package)
    np.testing.assert_array_equal(dev.numpy(), bst.predict(
        X, raw_score=True, pred_early_stop=False))


def test_predict_serving_matches_jax(dyadic):
    """The JAX package's ``predict_serving`` and the port's on trees
    trained equal: within 1e-6; the leaves equal."""
    X, z = rows(800)
    y = (z > 0.3).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
         "min_data_in_leaf": 10, "tpu_predict_buckets": "256",
         "tpu_serve_endpoints": "predict,leaf"}
    bj = lgb.train(dict(p, tpu_fused="off"), lgb.Dataset(X, label=y), 3)
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    x = X[:200]
    oj, nj = bj.predict_serving(x)
    ot, nt = bt.predict_serving(x)
    assert nj == nt == 200
    np.testing.assert_allclose(ot[:200], np.asarray(oj)[:200], atol=1e-6)
    lj, _ = bj.predict_leaf_serving(x)
    lt, _ = bt.predict_leaf_serving(x)
    np.testing.assert_array_equal(lt[:200], np.asarray(lj)[:200])


def test_warm_ladder_and_serving_stats():
    """``warm_predict_ladder`` reports rungs, endpoints and seconds (XLA's
    compile counters have no PyTorch counterpart and are left out); a
    batch above the ladder raises naming A18's sharded prediction."""
    bst = booster()
    stats = bst.warm_predict_ladder(max_rows=256)
    assert stats["rungs"] == [64, 256]
    assert stats["endpoints"] == ["contrib", "leaf", "predict"]
    assert stats["seconds"] >= 0
    assert not {"lowerings", "backend_compiles", "cache"} & set(stats)
    with pytest.raises(ValueError, match="A18"):
        bst.predict_serving(np.zeros((1025, 6), np.float32))


def test_server_futures_from_four_threads():
    """Mixed sizes from 4 client threads, with a short switch interval:
    every future equals ``predict`` of its rows and the counters add up
    (a lost update would break either)."""
    bst = booster()
    X, _ = rows()
    want = bst.predict(X)
    sizes = [1, 8, 64, 256]
    got, errors = {}, []
    interval = sys.getswitchinterval()
    with bst.serve(tick_ms=2.0, deadline_ms=20_000) as server:
        assert server.ready()

        def client(c):
            try:
                off = 100 * c
                for i, size in enumerate(sizes * 2):
                    lo = (off + 37 * i) % (len(X) - size)
                    got[(c, i)] = (lo, size,
                                   server.submit(X[lo:lo + size]))
            except Exception as err:  # noqa: BLE001 - re-raised below
                errors.append(err)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not errors and not any(t.is_alive() for t in threads)
        for lo, size, fut in got.values():
            np.testing.assert_array_equal(fut.result(), want[lo:lo + size])
            assert fut.version == "v0"
        leaf = server.predict_leaf(X[:5])
        np.testing.assert_array_equal(leaf, bst.predict(X[:5],
                                                        pred_leaf=True))
        stats = server.stats
    assert stats["served_requests"] == 4 * 8 + 1 and stats["errors"] == 0


def test_typed_errors():
    bst = booster()
    X, _ = rows()
    server = bst.serve(tick_ms=0.0, deadline_ms=20_000, queue_max=200)
    try:
        with inject("hang@coalesce_tick=1:seconds=1.0"):
            slow = server.submit(X[:200])          # the tick that hangs
            time.sleep(0.2)
            late = server.submit(X[:50], deadline_ms=100)
            with pytest.raises(ServerOverloaded):
                server.submit(X[:200])
            with pytest.raises(ServingTimeout):
                late.result()
            np.testing.assert_array_equal(slow.result(),
                                          bst.predict(X[:200]))
        with pytest.raises(ValueError, match="endpoint"):
            PredictionServer(booster(6, tpu_serve_endpoints="predict"),
                             warm=False).submit_leaf(X[:2])
    finally:
        server.close()
    with pytest.raises(ServerClosed):
        server.submit(X[:1])
    stats = server.stats
    assert stats["shed"] == 1 and stats["timeouts"] + stats["errors"] >= 0


def test_hot_swap_under_load_rollback_and_swap_fault():
    """A deploy while 4 clients submit fails no request (each is answered by
    one version, equal to its booster's predict); rollback restores the old
    version; a swap that overruns its deadline (``hang@swap``) leaves the
    active version as it was."""
    a, b = booster(4), booster(7)
    X, _ = rows()
    want = {"v0": a.predict(X), "v1": b.predict(X)}
    server = a.serve(tick_ms=1.0, deadline_ms=20_000)
    futs, stop = [], threading.Event()

    def client(c):
        i = 0
        while not stop.is_set() or i < 5:
            lo = (37 * i + 101 * c) % (len(X) - 16)
            futs.append((lo, server.submit(X[lo:lo + 16])))
            i += 1
            time.sleep(0.002)
    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.05)
        server.deploy("v1", b)
        time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        versions = set()
        for lo, fut in futs:
            out = fut.result()
            versions.add(fut.version)
            np.testing.assert_array_equal(out, want[fut.version][lo:lo + 16])
        assert versions == {"v0", "v1"}
        assert server.registry.active_version() == "v1"
        assert server.rollback() == "v0"
        np.testing.assert_array_equal(server.predict(X[:9]), want["v0"][:9])
        with inject("hang@swap=1:seconds=1.0"):
            with pytest.raises(SwapFailed):
                server.deploy("v2", booster(3), deadline_s=0.2)
        assert server.registry.active_version() == "v0"
        assert server.registry.failed_swaps == 1
        np.testing.assert_array_equal(server.predict(X[:9]), want["v0"][:9])
    finally:
        stop.set()
        server.close()
    assert server.stats["errors"] == 0


def test_serving_never_serves_stale_trees():
    """Continued training, rollback, reset_parameter and DART's rescales
    drop the device caches: each serving call equals ``predict`` after."""
    X, z = rows()
    y = (z > 0.3).astype(np.float64)
    for extra in ({}, {"boosting": "dart", "drop_rate": 0.5,
                       "skip_drop": 0.0}):
        bst = lgt.train(dict(BASE, **extra), lgt.Dataset(X, y), 3)
        x = X[:100]
        for step in ("update", "update", "rollback", "reset"):
            out, n = bst.predict_serving(x, raw_score=True)
            np.testing.assert_array_equal(out[:n], bst.predict(
                x, raw_score=True))
            leaves, _ = bst.predict_leaf_serving(x)
            np.testing.assert_array_equal(leaves[:n],
                                          bst.predict(x, pred_leaf=True))
            phi, _ = bst.predict_contrib_serving(x)
            _contrib_close(phi[:n], bst.predict(x, pred_contrib=True),
                           bst._gbdt)
            if step == "update":
                bst.update()
            elif step == "rollback":
                bst.rollback_one_iter()
            else:
                bst.reset_parameter({"learning_rate": 0.05})


def test_rwlock_readers_share_and_writers_run_alone():
    lock = RWLock()
    inside, most, log_ = [0], [0], []
    gate = threading.Barrier(3)

    def reader():
        with lock.read():
            inside[0] += 1
            most[0] = max(most[0], inside[0])
            gate.wait(timeout=5)
            time.sleep(0.05)
            inside[0] -= 1

    def writer():
        gate.wait(timeout=5)
        with lock.write():
            log_.append(inside[0])
    threads = [threading.Thread(target=reader) for _ in range(2)] \
        + [threading.Thread(target=writer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 2 and log_ == [0]
    with lock.write():
        with lock.read():
            with lock.write():
                pass
    with lock.read():
        with pytest.raises(RuntimeError, match="upgrade"):
            lock.acquire_write()
    holder = threading.Thread(target=lambda: (lock.acquire_read(),
                                              time.sleep(0.3),
                                              lock.release_read()))
    holder.start()
    time.sleep(0.05)
    assert lock.acquire_write(timeout=0.05) is False
    holder.join(timeout=30)
    assert not holder.is_alive()
    assert lock.acquire_write(timeout=1.0) is True
    lock.release_write()
    # a booster: an update waits for a prediction in flight
    bst = booster(3)
    order = []

    def slow_predict():
        with bst._api_lock.read():
            order.append("predict")
            time.sleep(0.2)
            order.append("predict done")
    t = threading.Thread(target=slow_predict)
    t.start()
    time.sleep(0.05)
    b2 = lgt.Booster(model_str=bst.model_to_string())
    assert b2.num_trees() == bst.num_trees()
    bst.update()
    order.append("update")
    t.join(timeout=30)
    assert not t.is_alive()
    assert order == ["predict", "predict done", "update"]
    bst.rollback_one_iter()


def test_drift_divergences_match_jax_and_a_shift_drifts():
    rng = np.random.RandomState(9)
    ref = rng.dirichlet(np.ones(16), size=7)
    cur = rng.dirichlet(np.ones(16), size=7)
    cur[:, 3] = 0.0
    valid = rng.rand(7, 16) > 0.1
    for fn in ("psi_rows", "kl_rows"):
        for v in (None, valid):
            np.testing.assert_allclose(
                getattr(drift, fn)(ref, cur, v),
                getattr(jax_drift, fn)(ref, cur, v), rtol=1e-12, atol=0)
    gid = drift.equal_mass_groups(ref, 5)
    np.testing.assert_array_equal(gid, jax_drift.equal_mass_groups(ref, 5))
    np.testing.assert_array_equal(drift.group_counts(ref, gid, 5),
                                  jax_drift.group_counts(ref, gid, 5))
    bst = booster()
    X, _ = rows()
    server = bst.serve(tick_ms=0.0, deadline_ms=20_000,
                       drift_flush_every=1000)
    try:
        mon = server.observer.drift
        assert mon is not None and mon.flushes == 0
        shifted = X.copy()
        shifted[:, 0] += 3 * np.nanstd(X[:, 0])
        records = []
        for stream in (X, shifted):
            for lo in range(0, 1024, 256):
                server.predict(stream[lo:lo + 256])
            records.append(mon.flush())
        assert mon.host_syncs == 2 and mon.flushes == 2
        assert records[0]["psi"]["Column_0"] < mon.threshold
        assert records[1]["psi"]["Column_0"] > mon.threshold
        assert "Column_0" in records[1]["drifted"]
        assert records[1]["window_rows"] == 1024
    finally:
        server.close()


def test_refusals_name_their_items(tmp_path):
    bst = booster()
    with pytest.raises(NotImplementedError, match="A19"):
        bst.serve(metrics_port=0)
    with pytest.raises(NotImplementedError, match="A19"):
        booster(6, tpu_metrics_port=9100).serve()
    with pytest.raises(NotImplementedError, match="A19"):
        booster(6, tpu_metrics_path=str(tmp_path / "m.jsonl"),
                tpu_drift_flush_every=4).serve()
    with bst.serve(warm=False) as server:
        with pytest.raises(NotImplementedError, match="A19"):
            server.serve_metrics(0)
        with pytest.raises(NotImplementedError, match="A19"):
            server.metrics_text()
        assert server.metrics()["ready"] is False
    with pytest.raises(NotImplementedError, match="A18"):
        lgt.train(dict(BASE, tpu_mesh_shape="2x1"),
                  lgt.Dataset(*rows(200)), 1)
    loaded = lgt.Booster(model_str=bst.model_to_string())
    with pytest.raises(NotImplementedError, match="A10c"):
        loaded.predict_serving(rows(5)[0])


def test_leaf_quant_serves_and_cli_probe(tmp_path, capsys):
    """``tpu_leaf_quant`` (refused before this slice) trains and serves;
    the serving command line's readiness probe exits 0."""
    bst = booster(5, tpu_leaf_quant="f16")
    X, _ = rows()
    out, n = bst.predict_serving(X[:40], raw_score=True)
    np.testing.assert_array_equal(out[:n], bst.predict(X[:40],
                                                       raw_score=True))
    assert 0 < bst._gbdt.leaf_quant_bound() < 1e-2
    X, z = rows(400)
    path = tmp_path / "train.csv"
    np.savetxt(path, np.column_stack([(z > 0).astype(float),
                                      np.nan_to_num(X)]), delimiter=",")
    code = serve_cli([str(path), "--rounds", "2", "--probe",
                      "--param", "device_type=cpu",
                      "--param", "objective=binary",
                      "--param", "tpu_predict_buckets=64"])
    assert code == 0
    assert '"ready": true' in capsys.readouterr().out
