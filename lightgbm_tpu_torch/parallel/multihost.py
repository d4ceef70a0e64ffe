"""The single-process part of ``lightgbm_tpu/parallel/multihost.py``: the
step watchdog.

``run_with_deadline`` runs a training step under a wall-clock deadline
(``tpu_collective_deadline_s``); a step that overruns surfaces as a
structured :class:`TrainingInterrupted`, on which ``engine.train`` writes
a final snapshot before it re-raises. The multi-host bootstrap, the
process mesh and the collectives of the JAX package's module are ROADMAP
A18; so is ``tpu_collective_retries``, which only that bootstrap reads
there. The JAX package's flight-recorder notes are ROADMAP A19 and are
left out. The serving registry runs a deploy's commit under it too.
"""
from __future__ import annotations

import threading
from typing import Callable


class TrainingInterrupted(RuntimeError):
    """A step overran its deadline (or a preemption surfaced): carries what
    was running and the deadline that fired. ``engine.train`` writes a
    final snapshot before re-raising it, so a run loses at most the
    iterations since its last checkpoint tick."""

    def __init__(self, what: str, deadline_s: float = 0.0):
        super().__init__(
            f"{what} exceeded its {deadline_s:.1f}s deadline"
            if deadline_s else what)
        self.what = what
        self.deadline_s = deadline_s


def run_with_deadline(fn: Callable, deadline_s: float, what: str):
    """Run ``fn()`` under a wall-clock watchdog (reference:
    ``run_with_deadline``, ``lightgbm_tpu/parallel/multihost.py:70-144``,
    less its bootstrap retries, which are ROADMAP A18's).

    ``fn`` runs in a daemon worker thread; if it has not finished within
    ``deadline_s`` seconds, :class:`TrainingInterrupted` is raised in the
    caller. ``deadline_s <= 0`` runs ``fn`` inline with no watchdog.

    A worker that overruns is abandoned, not killed (Python cannot
    interrupt a thread blocked in native code, such as a CUDA
    synchronisation): the caller is expected to snapshot and exit.
    """
    if not deadline_s or deadline_s <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _runner():
        try:
            box["value"] = fn()
        except BaseException as err:  # noqa: BLE001 - re-raised below
            box["error"] = err
        finally:
            done.set()

    threading.Thread(target=_runner, daemon=True,
                     name=f"lgbt-watchdog[{what}]").start()
    if not done.wait(deadline_s):
        raise TrainingInterrupted(what, deadline_s)
    if "error" in box:
        raise box["error"]
    return box.get("value")
