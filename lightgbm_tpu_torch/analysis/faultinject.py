"""Deterministic fault injection for the recovery paths.

Counterpart of ``lightgbm_tpu/analysis/faultinject.py``, with the same
spec grammar, sites and semantics. Checkpoint-and-resume and the step
watchdog exist to survive failures that are rare in the wild: a killed
process, a step that never returns, a snapshot damaged on disk. This module
makes each of them injectable on demand, so that every recovery path runs
in the tests.

Faults are described by a spec string, from the ``LGBM_TPU_FAULTS``
environment variable or the ``tpu_fault_spec`` parameter::

    kill@iteration=3                 raise SimulatedKill before iteration 3
    hang@step=2:seconds=60           sleep 60 s inside the watchdog-wrapped
                                     training step of iteration 2
    transient@backend_init=1:count=2 fail the first two backend-init
                                     attempts with a transient error
    corrupt@snapshot=2               corrupt the 2nd snapshot file written
    corrupt@snapshot=2:mode=flip     ... by flipping payload bytes instead
                                     of truncating

Faults join with ``;``. Each fires ``count`` times (default 1) and then
disarms. The port's training fires ``iteration`` (engine.train, before
each boosting iteration, ``iteration=`` the 0-based index), ``step``
(just before ``booster.update()``, inside the watchdog when one is set)
and ``snapshot`` (io/checkpoint.py, after a snapshot file lands; 1-based
ordinal; ``corrupt`` damages it). Serving fires ``request``
(``PredictionServer.submit``), ``coalesce_tick`` (each coalescer tick,
outside its queue lock), ``warmup`` (each rung of
``Booster.warm_predict_ladder``) and ``swap`` (a deploy's commit, inside
its deadline). The other sites of the JAX package (``barrier``,
``backend_init``, ``bench_update``) parse and never fire until the
modules that fire them are ported (ROADMAP A18).

Injection sites call :func:`active_plan` and ``fire()``: a no-op
``NullPlan`` when no spec is set. Tests arm plans with :func:`inject`.
The JAX package's flight-recorder notes are ROADMAP A19 and are left
out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

from ..utils import log

#: the message a transient-fault injection carries
TRANSIENT_MESSAGE = "Unable to initialize backend (injected transient fault)"


class SimulatedKill(BaseException):
    """An injected ``kill -9``: it subclasses BaseException, so it escapes
    every ``except Exception`` and no cleanup path writes a snapshot;
    recovery must come from the last periodic snapshot, as after a real
    kill."""


class FaultSpecError(ValueError):
    """A malformed ``LGBM_TPU_FAULTS`` / ``tpu_fault_spec`` string."""


_KINDS = ("kill", "hang", "transient", "corrupt")
_SITES = ("iteration", "step", "barrier", "backend_init", "snapshot",
          "bench_update", "request", "coalesce_tick", "warmup", "swap")


@dataclasses.dataclass
class Fault:
    kind: str                    # kill | hang | transient | corrupt
    site: str                    # one of _SITES
    at: int                      # the first position it fires at; -1: any
    count: int = 1               # fires before disarming; -1: unlimited
    seconds: float = 3600.0      # hang: the sleep
    mode: str = "truncate"       # corrupt: truncate | flip
    fired: int = 0

    def spent(self) -> bool:
        return self.count >= 0 and self.fired >= self.count


def parse_spec(spec: str) -> List[Fault]:
    """Parse ``kind@site=at[:key=val...]`` clauses joined by ``;``."""
    faults: List[Fault] = []
    for clause in (c.strip() for c in spec.split(";")):
        if not clause:
            continue
        if "@" not in clause:
            raise FaultSpecError(
                f"fault clause {clause!r} needs kind@site=at")
        kind, _, rest = clause.partition("@")
        kind = kind.strip().lower()
        if kind not in _KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} (one of {_KINDS})")
        parts = rest.split(":")
        site, _, at_s = parts[0].partition("=")
        site = site.strip().lower()
        if site not in _SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} (one of {_SITES})")
        try:
            at = int(at_s) if at_s.strip() not in ("", "*") else -1
        except ValueError:
            raise FaultSpecError(
                f"fault clause {clause!r}: non-integer position {at_s!r}")
        fault = Fault(kind=kind, site=site, at=at)
        for extra in parts[1:]:
            key, _, val = extra.partition("=")
            key = key.strip().lower()
            if key == "count":
                fault.count = int(val)
            elif key == "seconds":
                fault.seconds = float(val)
            elif key == "mode":
                if val not in ("truncate", "flip"):
                    raise FaultSpecError(
                        f"corrupt mode {val!r} (truncate|flip)")
                fault.mode = val
            else:
                raise FaultSpecError(
                    f"unknown fault option {key!r} in {clause!r}")
        faults.append(fault)
    return faults


def corrupt_file(path: str, mode: str = "truncate") -> None:
    """Damage a snapshot file in place: cut it to half its size, or flip
    eight bytes in its middle (a torn write or a bad disk, which the
    atomic rename alone does not prevent)."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(max(size // 2, 1))
    else:
        with open(path, "r+b") as fh:
            fh.seek(max(size // 2, 0))
            chunk = fh.read(8)
            fh.seek(max(size // 2, 0))
            fh.write(bytes(b ^ 0xFF for b in chunk))


class FaultPlan:
    """A parsed fault set and the fire ordinal of each site."""

    def __init__(self, faults: List[Fault]):
        self.faults = faults
        self._site_ordinal: Dict[str, int] = {}

    def fire(self, site: str, **ctx) -> None:
        """Trigger any armed fault of ``site`` at this position: the
        ``iteration=`` given, else the site's 1-based fire ordinal. A fault
        fires from position ``at`` on while its ``count`` lasts."""
        ordinal = self._site_ordinal.get(site, 0) + 1
        self._site_ordinal[site] = ordinal
        position = ctx.get("iteration", ordinal)
        for f in self.faults:
            if f.site != site or f.spent():
                continue
            if f.at >= 0 and position < f.at:
                continue
            f.fired += 1
            self._trigger(f, ctx)

    def _trigger(self, f: Fault, ctx: dict) -> None:
        where = f"{f.site}@{ctx.get('iteration', self._site_ordinal[f.site])}"
        if f.kind == "kill":
            log.warning(f"[faultinject] simulated kill at {where}")
            raise SimulatedKill(f"injected kill at {where}")
        if f.kind == "hang":
            log.warning(f"[faultinject] injected hang at {where} "
                        f"({f.seconds:.0f}s)")
            time.sleep(f.seconds)
            return
        if f.kind == "transient":
            log.warning(f"[faultinject] injected transient failure at "
                        f"{where}")
            raise RuntimeError(TRANSIENT_MESSAGE)
        if f.kind == "corrupt":
            path = ctx.get("path")
            if path and os.path.exists(path):
                log.warning(f"[faultinject] corrupting snapshot {path} "
                            f"({f.mode})")
                corrupt_file(path, f.mode)


class NullPlan:
    """Armed when no spec is set: ``fire()`` does nothing."""

    faults: List[Fault] = []

    def fire(self, site: str, **ctx) -> None:
        return None


_NULL = NullPlan()
_installed: Optional[FaultPlan] = None
_env_plan: Optional[FaultPlan] = None
_env_spec: Optional[str] = None
_config_plan: Optional[FaultPlan] = None
_config_spec: Optional[str] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) an explicit plan; it wins over the
    environment."""
    global _installed
    _installed = plan


@contextlib.contextmanager
def inject(spec: str):
    """Arm ``spec`` for the block and restore the previous plan after it;
    yields the plan, whose faults' ``fired`` counters a test can read."""
    plan = FaultPlan(parse_spec(spec))
    prev = _installed
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def active_plan(config=None):
    """The armed plan: an installed one, else ``LGBM_TPU_FAULTS``, else the
    ``tpu_fault_spec`` of ``config``, else the ``NullPlan``.

    A plan from the environment or a config is built once for each
    distinct spec and keeps its counters for the life of the process (a
    ``count=1`` fault fires once a process). A config's plan stays armed
    for the sites that have no config in hand (snapshot writes) until a
    config with an empty spec disarms it."""
    global _env_plan, _env_spec, _config_plan, _config_spec
    if _installed is not None:
        return _installed
    spec = os.environ.get("LGBM_TPU_FAULTS", "")
    if spec:
        if spec != _env_spec:
            _env_plan = FaultPlan(parse_spec(spec))
            _env_spec = spec
        return _env_plan
    if config is not None:
        try:
            cspec = str(config.get("tpu_fault_spec", "") or "")
        except Exception:
            cspec = ""
        if cspec != _config_spec:
            _config_plan = FaultPlan(parse_spec(cspec)) if cspec else None
            _config_spec = cspec
    return _config_plan if _config_plan is not None else _NULL
