"""Resumable training in the port on the CPU: full-state checkpoints,
fault injection and the step watchdog, held against the port's own
uninterrupted runs bit for bit and against the JAX package's.

* the file contract (``io/checkpoint.py``, ported from
  ``tests/test_checkpoint.py``): atomic writes, the checksum header,
  keep-last-k rotation, ``load_latest`` skipping damaged snapshots, no
  orphan temporary file after a kill at or inside a write; no pickle is
  ever loaded, and a JAX-package snapshot is refused;
* the fault-spec grammar (``analysis/faultinject.py``);
* the watchdog (``parallel/multihost.py``) with short deadlines, and an
  injected ``hang@step`` that ``tpu_collective_deadline_s`` interrupts with
  a final snapshot;
* a run killed by an injected fault and resumed equals the uninterrupted
  run bit for bit (model text and predictions): compact and masked,
  bagging, GOSS, DART, quantized with stochastic rounding, early stopping,
  a double kill, a corrupt newest snapshot, an incompatible snapshot
  (ignored with a warning), a finished run's snapshot (a no-op);
* the resumed model has the JAX package's uninterrupted trees (split for
  split) and predictions within 1e-6, on the compact grower against the
  fused kernel in interpret mode and on the masked grower, with the same
  bag draws and gradients rounded to a 1/64 grid in both packages.
"""
import hashlib
import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.io import checkpoint as jax_ckpt
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.analysis import faultinject
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.io import checkpoint as ckpt
from lightgbm_tpu_torch.parallel.multihost import (TrainingInterrupted,
                                                   run_with_deadline)
from lightgbm_tpu_torch.utils import log as tlog
from test_torch_sampling import assert_same_trees, jax_uniform

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
        "max_bin": 31, "learning_rate": 0.1, "verbosity": -1,
        "device_type": "cpu"}


def _data(n=600, f=8, seed=42):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 2] + 0.6 * rng.randn(n) > 0).astype(float)
    return X, y


X, Y = _data()
XV, YV = _data(300, seed=5)


def _trees(bst) -> str:
    """Model text without the parameter dump (the checkpoint keys show
    there by design)."""
    return bst.model_to_string().split("\nparameters:")[0]


def _train(params, rounds, valid=False, callbacks=None):
    ds = lgt.Dataset(X, Y)
    vs = [ds.create_valid(XV, YV)] if valid else None
    return lgt.train(params, ds, rounds, valid_sets=vs,
                     callbacks=list(callbacks or ()))


def _kill_and_resume(params, rounds, kill_at, tmp_path, freq=3, **kw):
    p = dict(params, tpu_checkpoint_dir=str(tmp_path),
             tpu_checkpoint_freq=freq)
    with faultinject.inject(f"kill@iteration={kill_at}"):
        with pytest.raises(faultinject.SimulatedKill):
            _train(p, rounds, **kw)
    return _train(p, rounds, **kw)


def _assert_same(ref, res):
    assert _trees(ref) == _trees(res)
    assert np.array_equal(ref.predict(X), res.predict(X))


# ---- io/checkpoint.py ----

def test_write_read_roundtrip(tmp_path):
    state = {"iteration": 5, "models": ["t0", "t1"], "arr": np.arange(7.0),
             "rng": np.random.RandomState(3).get_state(),
             "nested": {"x": (1, 2.5, None), "inf": float("-inf")}}
    path = ckpt.write_snapshot(str(tmp_path), 5, state)
    assert os.path.basename(path) == "snapshot_iter_000000005.ckpt"
    back = ckpt.read_snapshot(path)
    assert back["iteration"] == 5 and back["models"] == ["t0", "t1"]
    np.testing.assert_array_equal(back["arr"], state["arr"])
    assert back["nested"] == state["nested"]
    rs = np.random.RandomState()
    rs.set_state(back["rng"])
    assert rs.rand() == np.random.RandomState(3).rand()


def test_no_temp_files_left_behind(tmp_path):
    ckpt.write_snapshot(str(tmp_path), 1, {"iteration": 1})
    ckpt.write_snapshot(str(tmp_path), 2, {"iteration": 2})
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith(".snapshot_tmp_")]


@pytest.mark.parametrize("mode,match", [("truncate", "torn write"),
                                        ("flip", "checksum")])
def test_damaged_snapshot_detected(tmp_path, mode, match):
    path = ckpt.write_snapshot(str(tmp_path), 1,
                               {"iteration": 1, "x": np.arange(100)})
    faultinject.corrupt_file(path, mode)
    with pytest.raises(ckpt.SnapshotCorrupt, match=match):
        ckpt.read_snapshot(path)


def test_bad_magic_detected(tmp_path):
    path = tmp_path / "snapshot_iter_000000001.ckpt"
    path.write_bytes(b"NOTACKPT" + b"\x00" * 64)
    with pytest.raises(ckpt.SnapshotCorrupt, match="magic"):
        ckpt.read_snapshot(str(path))


def test_load_latest_skips_corrupt_to_previous_valid(tmp_path):
    ckpt.write_snapshot(str(tmp_path), 4, {"iteration": 4, "tag": "ok"})
    newest = ckpt.write_snapshot(str(tmp_path), 8,
                                 {"iteration": 8, "tag": "newest"})
    faultinject.corrupt_file(newest, "flip")
    state = ckpt.load_latest(str(tmp_path))
    assert state["tag"] == "ok" and state["iteration"] == 4
    assert ckpt.load_latest(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("keep,left", [(3, [4, 5, 6]),
                                       (0, [1, 2, 3, 4, 5, 6])])
def test_keep_last_k_rotation(tmp_path, keep, left):
    for i in range(1, 7):
        ckpt.write_snapshot(str(tmp_path), i, {"iteration": i}, keep=keep)
    assert [it for it, _ in ckpt.list_snapshots(str(tmp_path))] == left


class _Boom:
    """Unpickling it would append to ``UNPICKLED``."""

    def __reduce__(self):
        return (UNPICKLED.append, (1,))


UNPICKLED = []


@pytest.mark.parametrize("payload", [b"\x00garbage, not an archive",
                                     pickle.dumps({"iteration": _Boom()})])
def test_undecodable_payload_detected_and_no_pickle_loaded(tmp_path,
                                                          payload):
    blob = (ckpt.MAGIC + len(payload).to_bytes(8, "big")
            + hashlib.sha256(payload).digest() + payload)
    path = tmp_path / "snapshot_iter_000000003.ckpt"
    path.write_bytes(blob)
    with pytest.raises(ckpt.SnapshotCorrupt, match="undecodable"):
        ckpt.read_snapshot(str(path))
    assert UNPICKLED == []


def test_jax_package_snapshot_is_refused(tmp_path, monkeypatch):
    """The JAX package's pickled snapshot is never loaded by the port:
    ``SnapshotCorrupt`` ("not a port snapshot"), skipped with a warning."""
    path = jax_ckpt.write_snapshot(str(tmp_path), 2,
                                   {"iteration": 2, "boom": _Boom()})
    with pytest.raises(ckpt.SnapshotCorrupt, match="not a port snapshot"):
        ckpt.read_snapshot(path)
    said = []
    monkeypatch.setattr(tlog, "warning", said.append)
    assert ckpt.load_latest(str(tmp_path)) is None
    assert UNPICKLED == [] and "not a port snapshot" in said[0]


def test_kill_at_snapshot_leaves_no_orphan_tmp(tmp_path):
    with faultinject.inject("kill@snapshot=1"):
        with pytest.raises(faultinject.SimulatedKill):
            ckpt.write_snapshot(str(tmp_path), 1, {"iteration": 1})
    names = os.listdir(tmp_path)
    assert not [n for n in names if n.startswith(".snapshot_tmp_")], names
    assert "snapshot_iter_000000001.ckpt" in names


def test_simulated_kill_mid_write_unlinks_temp(tmp_path, monkeypatch):
    def grenade(src, dst):
        raise faultinject.SimulatedKill("mid-write replace")
    monkeypatch.setattr(os, "replace", grenade)
    with pytest.raises(faultinject.SimulatedKill):
        ckpt.write_snapshot(str(tmp_path), 2, {"iteration": 2})
    monkeypatch.undo()
    assert os.listdir(str(tmp_path)) == []


# ---- analysis/faultinject.py ----

def test_parse_clauses():
    faults = faultinject.parse_spec(
        "kill@iteration=3; hang@step=2:seconds=9.5;"
        "transient@backend_init=1:count=2;corrupt@snapshot=2:mode=flip")
    assert [(f.kind, f.site, f.at) for f in faults] == [
        ("kill", "iteration", 3), ("hang", "step", 2),
        ("transient", "backend_init", 1), ("corrupt", "snapshot", 2)]
    assert faults[1].seconds == 9.5 and faults[2].count == 2
    assert faults[3].mode == "flip"


@pytest.mark.parametrize("bad", [
    "kill", "vaporize@iteration=1", "kill@nowhere=1", "kill@iteration=x",
    "corrupt@snapshot=1:mode=zap", "kill@iteration=1:wat=1"])
def test_parse_errors(bad):
    with pytest.raises(faultinject.FaultSpecError):
        faultinject.parse_spec(bad)


@pytest.mark.parametrize("at", ["*", "1"])
def test_fault_fires_count_times_then_disarms(at):
    with faultinject.inject(f"transient@backend_init={at}:count=2") as plan:
        for _ in range(2):
            with pytest.raises(RuntimeError,
                               match="Unable to initialize backend"):
                plan.fire("backend_init")
        plan.fire("backend_init")
        assert plan.faults[0].fired == 2


def test_inject_restores_previous_plan():
    assert isinstance(faultinject.active_plan(), faultinject.NullPlan)
    with faultinject.inject("kill@iteration=1"):
        assert not isinstance(faultinject.active_plan(),
                              faultinject.NullPlan)
    assert isinstance(faultinject.active_plan(), faultinject.NullPlan)


def test_kill_escapes_except_exception():
    with faultinject.inject("kill@iteration=0"):
        with pytest.raises(faultinject.SimulatedKill):
            try:
                faultinject.active_plan().fire("iteration", iteration=0)
            except Exception:       # noqa: BLE001 - the point
                pytest.fail("SimulatedKill caught by except Exception")


def test_config_spec_reaches_the_snapshot_site(tmp_path):
    """``tpu_fault_spec`` from the parameters drives the snapshot site,
    which holds no config: the first snapshot is corrupted."""
    p = dict(BASE, tpu_fault_spec="corrupt@snapshot=1",
             tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2)
    try:
        _train(p, 4)
    finally:
        faultinject.active_plan({"tpu_fault_spec": ""})
    snaps = ckpt.list_snapshots(str(tmp_path))
    assert len(snaps) == 2
    with pytest.raises(ckpt.SnapshotCorrupt):
        ckpt.read_snapshot(snaps[0][1])
    ckpt.read_snapshot(snaps[1][1])


# ---- parallel/multihost.py: the watchdog ----

def test_watchdog_returns_values():
    assert run_with_deadline(lambda: 41 + 1, 0.0, "inline") == 42
    assert run_with_deadline(lambda: "ok", 5.0, "fast fn") == "ok"


def test_watchdog_deadline_fires_structured():
    t0 = time.time()
    with pytest.raises(TrainingInterrupted) as err:
        run_with_deadline(lambda: time.sleep(5), 0.2, "hung step")
    assert time.time() - t0 < 3
    assert err.value.what == "hung step" and err.value.deadline_s == 0.2
    assert "deadline" in str(err.value)


def test_watchdog_worker_exception_propagates():
    with pytest.raises(ZeroDivisionError):
        run_with_deadline(lambda: 1 // 0, 5.0, "failing fn")


def test_collective_deadline_interrupts_a_hung_step(tmp_path):
    """``tpu_collective_deadline_s`` acts: a hang injected into the step of
    iteration 4 surfaces as ``TrainingInterrupted`` with a final snapshot
    of the 4 finished iterations, and the resumed run equals the
    uninterrupted one bit for bit."""
    p = dict(BASE, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=3,
             tpu_collective_deadline_s=1.0)
    with faultinject.inject("hang@step=4:seconds=6"):
        with pytest.raises(TrainingInterrupted):
            _train(p, 6)
    assert ckpt.load_latest(str(tmp_path))["iteration"] == 4
    _assert_same(_train(BASE, 6), _train(p, 6))


@pytest.mark.parametrize("overrun", ["held", "finished_late"])
def test_an_overrunning_update_is_never_snapshotted(overrun, tmp_path,
                                                     monkeypatch):
    """An update that overruns mid-tree (slowed after its tree is grown,
    before the scores and the model take it) is never written half-applied:
    the final snapshot is skipped whether the update still holds the
    booster when the snapshot gives up (``held``) or finishes while the
    snapshot waits (``finished_late``), and the resumed run starts from the
    last periodic tick and equals the uninterrupted run bit for bit."""
    p = dict(BASE, tpu_grower="compact", bagging_fraction=0.7,
             bagging_freq=1)
    ref = _train(p, 6)
    p.update(tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2,
             tpu_collective_deadline_s=0.5)
    release, calls = threading.Event(), []
    orig = gbdt_mod.HostTree.from_device

    def slow(cls, tree, shrinkage):
        calls.append(threading.current_thread())
        if len(calls) == 4:         # inside iteration 3's update
            if overrun == "held":
                release.wait(30)
            else:
                time.sleep(0.7)
        return orig(tree, shrinkage)
    monkeypatch.setattr(gbdt_mod.HostTree, "from_device", classmethod(slow))
    said = []
    monkeypatch.setattr(tlog, "warning", said.append)
    with pytest.raises(TrainingInterrupted):
        _train(p, 6)
    release.set()
    calls[3].join(30)               # the abandoned update ends
    monkeypatch.undo()
    assert any("final snapshot failed" in s for s in said)
    assert ckpt.load_latest(str(tmp_path))["iteration"] == 2
    _assert_same(ref, _train(p, 6))


# ---- kill and resume: equal bits on the CPU ----

CONFIGS = {
    "compact": {"tpu_grower": "compact"},
    "masked": {"tpu_grower": "masked"},
    "bagging": {"tpu_grower": "compact", "bagging_fraction": 0.7,
                "bagging_freq": 2, "feature_fraction": 0.8},
    "goss": {"data_sample_strategy": "goss", "top_rate": 0.3,
             "other_rate": 0.2, "learning_rate": 0.5},
    "dart": {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0,
             "tpu_grower": "compact"},
    "quantized": {"tpu_grower": "compact", "use_quantized_grad": True,
                  "stochastic_rounding": True},
    "bynode_extra": {"tpu_grower": "masked", "feature_fraction_bynode": 0.7,
                     "extra_trees": True},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kill_and_resume_is_bit_identical(name, tmp_path):
    p = dict(BASE, **CONFIGS[name])
    _assert_same(_train(p, 7), _kill_and_resume(p, 7, 5, tmp_path))


@pytest.mark.parametrize("kill_at", [1, 3])
def test_kill_points_before_and_on_a_tick(kill_at, tmp_path):
    """A kill before the first snapshot restarts from 0; one right on a
    tick resumes there."""
    p = dict(BASE, tpu_grower="compact")
    _assert_same(_train(p, 5), _kill_and_resume(p, 5, kill_at, tmp_path))


def test_double_kill_then_resume(tmp_path):
    p = dict(BASE, tpu_grower="compact", bagging_fraction=0.7,
             bagging_freq=3, tpu_checkpoint_dir=str(tmp_path),
             tpu_checkpoint_freq=2)
    for kill_at in (3, 6):
        with faultinject.inject(f"kill@iteration={kill_at}"):
            with pytest.raises(faultinject.SimulatedKill):
                _train(p, 8)
    _assert_same(_train(dict(BASE, tpu_grower="compact",
                             bagging_fraction=0.7, bagging_freq=3), 8),
                 _train(p, 8))


def test_early_stopping_resumes_to_the_same_iteration(tmp_path):
    p = dict(BASE, learning_rate=0.2, num_leaves=15)
    es = [lgt.early_stopping(2, verbose=False)]
    ref = _train(p, 30, valid=True, callbacks=es)
    assert 7 < ref.num_trees() < 30
    res = _kill_and_resume(p, 30, 7, tmp_path, freq=2, valid=True,
                           callbacks=[lgt.early_stopping(2, verbose=False)])
    assert ref.best_iteration == res.best_iteration
    assert ref.best_score == res.best_score
    _assert_same(ref, res)


def test_resume_adds_early_stopping_not_in_killed_run(tmp_path):
    p = dict(BASE, learning_rate=0.2, num_leaves=15,
             tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2)
    with faultinject.inject("kill@iteration=7"):
        with pytest.raises(faultinject.SimulatedKill):
            _train(p, 30, valid=True)
    res = _train(p, 30, valid=True,
                 callbacks=[lgt.early_stopping(2, verbose=False)])
    assert res.best_iteration > 6 and res.num_trees() < 30


def test_resume_from_corrupted_newest_falls_back(tmp_path):
    p = dict(BASE, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2)
    with faultinject.inject("corrupt@snapshot=2:mode=flip;kill@iteration=5"):
        with pytest.raises(faultinject.SimulatedKill):
            _train(p, 6)
    assert ckpt.load_latest(str(tmp_path))["iteration"] == 2
    _assert_same(_train(BASE, 6), _train(p, 6))


def test_incompatible_snapshot_ignored_with_a_warning(tmp_path,
                                                      monkeypatch):
    _train(dict(BASE, num_leaves=15, tpu_checkpoint_dir=str(tmp_path),
                tpu_checkpoint_freq=2), 4)
    said = []
    monkeypatch.setattr(tlog, "warning", said.append)
    bst = _train(dict(BASE, tpu_checkpoint_dir=str(tmp_path)), 4)
    assert any("incompatible checkpoint" in s and "num_leaves" in s
               for s in said)
    assert _trees(bst) == _trees(_train(BASE, 4))


def test_finished_run_snapshot_resumes_to_noop(tmp_path):
    p = dict(BASE, tpu_checkpoint_dir=str(tmp_path), tpu_checkpoint_freq=2)
    first = _train(p, 4)
    again = _train(p, 4)
    assert again.num_trees() == first.num_trees() == 4
    _assert_same(first, again)


def test_snapshot_state_is_complete_and_numpy_only(tmp_path):
    """A snapshot of a sampled compact run holds the records, the bag cache
    and every generator that exists, in arrays an ``allow_pickle=False``
    load reads; restoring it into a fresh trainer gives the same state."""
    p = dict(BASE, **CONFIGS["bagging"], feature_fraction_bynode=0.8,
             extra_trees=True)
    bst = lgt.Booster(p, lgt.Dataset(X, Y))
    for _ in range(3):
        bst.update()
    path = bst.save_checkpoint(str(tmp_path))
    state = ckpt.read_snapshot(path)
    assert set(state["generators"]) == {"bag", "extra", "bynode"}
    assert state["compact"]["work"].dtype == np.uint8
    assert state["bag_cached"] is not None and state["iteration"] == 3
    fresh = lgt.Booster(p, lgt.Dataset(X, Y))
    fresh._restore_checkpoint(state)
    again = fresh._capture_checkpoint()
    for key in ("train_score", "bag_cached"):
        assert np.array_equal(again[key], state[key])
    assert np.array_equal(again["compact"]["work"], state["compact"]["work"])


# ---- held against the JAX package's uninterrupted run ----

@pytest.fixture
def dyadic_same_bags(monkeypatch):
    """Binary gradients on a 1/64 grid in both packages (every histogram
    sum exact), and the port's bags from the JAX package's draws."""
    jg, tg = jobj.BinaryLogloss.get_gradients, tobj.BinaryLogloss.get_gradients

    def jround(self, score):
        g, h = jg(self, score)
        return jnp.round(g * 64) / 64, jnp.maximum(jnp.round(h * 64), 1) / 64

    def tround(self, score, label, weight=None):
        g, h = tg(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", jround)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", tround)
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = jax_uniform
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


@pytest.mark.parametrize("grower,oracle", [
    ("compact", {"tpu_fused": "on", "tpu_fused_interpret": True,
                 "tpu_hist_mbatch": 1}),
    ("masked", {})])
def test_resumed_run_matches_jax_uninterrupted(grower, oracle,
                                               dyadic_same_bags, tmp_path):
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
         "max_bin": 31, "bagging_fraction": 0.8, "bagging_freq": 2,
         "tpu_grower": grower, "verbosity": -1}
    bj = lgb.train(dict(p, **oracle), lgb.Dataset(X, label=Y), 3)
    res = _kill_and_resume(dict(p, device_type="cpu"), 3, 2, tmp_path,
                           freq=2)
    assert res._gbdt.use_compact == bj._gbdt._use_compact
    assert_same_trees(bj._gbdt.models, res._gbdt.models)
    np.testing.assert_allclose(res.predict(X), np.asarray(bj.predict(X)),
                               rtol=0, atol=1e-6)


# ---- the deterministic mode's plain versions (ops/determinism.py) ----

def _dyadic_channels(rng, n, k):
    ch = rng.randint(-128, 129, (n, k)) / 64.0
    ch[:, -1] = rng.randint(0, 2, n)
    return ch.astype(np.float32)


@pytest.mark.parametrize("entry", ["dense", "sublane", "records"])
def test_fixed_point_histograms_match_jax_on_dyadic_channels(entry):
    """The plain versions of K1's, K2's and K3's deterministic mode (the
    fixed-point sums the kernels must equal bit for bit) against the JAX
    package's histogram: on 1/64-grid channels every sum is exact in both,
    so they agree bit for bit."""
    from lightgbm_tpu.ops.histogram import _xla_histogram as jax_hist
    from lightgbm_tpu_torch.ops.compact import RowLayout, pack_rows
    from lightgbm_tpu_torch.ops.determinism import channel_scale
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        pallas_histogram, pallas_histogram_sublane, record_histogram)
    rng = np.random.RandomState(3)
    n, f, b = 3000, 5, 64
    bins = rng.randint(0, b, (n, f)).astype(np.uint8)
    ch = _dyadic_channels(rng, n, 3)
    ref = np.asarray(jax_hist(jnp.asarray(bins), jnp.asarray(ch), b))
    tb, tc = torch.from_numpy(bins), torch.from_numpy(ch)
    det = channel_scale(tc, n)
    if entry == "dense":
        got = pallas_histogram(tb, tc, b, mode="f32", det=det)
    elif entry == "sublane":
        got = pallas_histogram_sublane(tb.T.contiguous(), tc, b, "f32", det)
    else:
        layout = RowLayout(num_features=f, num_extra=0)
        work = pack_rows(tb, tc[:, 0], tc[:, 1], tc[:, 2],
                         torch.zeros(0, n), layout)
        det = channel_scale(torch.cat([tc, torch.ones(n, 1)], 1), n)
        got = record_histogram(work, torch.zeros_like(work),
                               torch.tensor([0, n, 0], dtype=torch.int32),
                               layout, b, det=det)[..., :2]
        ref = ref[..., :2]
    assert np.array_equal(got.numpy(), ref)


def test_det_scale_keeps_every_sum_in_int64():
    from lightgbm_tpu_torch.ops.determinism import det_scale
    amax = torch.tensor([1.0, 0.25, 3e-30, 0.0, 7.5e5])
    for n in (1, 600, 10_500_000, 1 << 24):
        s = det_scale(amax, n).numpy()
        bound = amax.double().numpy() * n * s
        assert (bound < 2.0 ** 62).all()
        live = amax.numpy() > 0
        # the largest such power of two: twice it would pass the bound
        assert (2 * bound[live] >= 2.0 ** 62).all()
        assert s[3] == 2.0 ** 62 and (np.log2(s) % 1 == 0).all()


def test_det_cumsum_is_a_scan_only_inside_the_mode():
    from lightgbm_tpu_torch.ops import determinism
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 5, 37)
                         .astype(np.float32))
    assert torch.equal(determinism.cumsum(x, -1), torch.cumsum(x, -1))
    with determinism.deterministic_algorithms():
        assert determinism.active()
        assert torch.are_deterministic_algorithms_enabled()
        got = determinism.cumsum(x, 1)
    assert not determinism.active()
    assert not torch.are_deterministic_algorithms_enabled()
    torch.testing.assert_close(got, torch.cumsum(x, 1), rtol=0, atol=1e-5)


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_deterministic_training_on_the_cpu(grower):
    """deterministic=True on the CPU takes the fixed-point plain versions
    and the log-step scans: the model stays within f32 rounding of the
    default mode's, and PyTorch's setting is restored after train."""
    p = dict(BASE, tpu_grower=grower)
    a = _train(dict(p, deterministic=True), 5)
    assert not torch.are_deterministic_algorithms_enabled()
    np.testing.assert_allclose(a.predict(X), _train(p, 5).predict(X),
                               rtol=0, atol=1e-5)
