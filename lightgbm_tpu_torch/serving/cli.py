"""Stand up a PredictionServer from the command line.

Counterpart of ``lightgbm_tpu/serving/cli.py``: trains (or resumes, with
``--checkpoint-dir``) a booster on a CSV on the card, warms the serving
ladder, then either prints the health JSON and exits 0 when ready
(``--probe``, a readiness gate), or reads CSV feature rows from stdin, one
request a line, micro-batches them through the coalescer and prints one
prediction a line; end of input drains the server and writes its stats to
stderr. ``--param device_type=cpu`` runs it on the CPU. Example::

    python -m lightgbm_tpu_torch.serving.cli train.csv --rounds 50 \
        --param objective=binary --param num_leaves=63 --tick-ms 2 --probe
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _parse_params(pairs: List[str]) -> dict:
    out: dict = {}
    for pair in pairs or ():
        key, sep, value = pair.partition("=")
        if not sep:
            raise SystemExit(f"--param expects key=value, got {pair!r}")
        for cast in (int, float):
            try:
                out[key] = cast(value)
                break
            except ValueError:
                continue
        else:
            out[key] = value
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.serving.cli",
        description=__doc__.splitlines()[0])
    ap.add_argument("data", help="training CSV (label in --label-col)")
    ap.add_argument("--label-col", type=int, default=0,
                    help="label column index in the CSV (default 0)")
    ap.add_argument("--rounds", type=int, default=20,
                    help="boosting rounds to train before serving")
    ap.add_argument("--param", action="append", default=[],
                    help="extra training param key=value (repeatable), "
                         "e.g. --param objective=binary")
    ap.add_argument("--tick-ms", type=float, default=None,
                    help="coalescer tick (tpu_serve_tick_ms)")
    ap.add_argument("--queue-max", type=int, default=None,
                    help="admission bound in rows (tpu_serve_queue_max)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (tpu_serve_deadline_ms)")
    ap.add_argument("--warm-max-rows", type=int, default=None,
                    help="cap the warmed ladder rungs "
                         "(tpu_serve_warm_max_rows; 0 = full ladder)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="tpu_checkpoint_dir: training resumes from the "
                         "newest valid snapshot")
    ap.add_argument("--raw-score", action="store_true",
                    help="serve raw scores (skip objective conversion)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="the Prometheus endpoint (not in the PyTorch port "
                         "yet: ROADMAP A19)")
    ap.add_argument("--probe", action="store_true",
                    help="print health JSON and exit 0 iff ready")
    args = ap.parse_args(argv)

    import numpy as np

    import lightgbm_tpu_torch as lgb

    arr = np.loadtxt(args.data, delimiter=",", ndmin=2)
    y = arr[:, args.label_col]
    x = np.delete(arr, args.label_col, axis=1)
    params = {"verbosity": -1}
    params.update(_parse_params(args.param))
    if args.checkpoint_dir:
        params.setdefault("tpu_checkpoint_dir", args.checkpoint_dir)
        params.setdefault("tpu_checkpoint_freq",
                          max(args.rounds // 4, 1))
    booster = lgb.train(params, lgb.Dataset(x, label=y, params=params),
                        num_boost_round=args.rounds)
    server = booster.serve(
        tick_ms=args.tick_ms, queue_max=args.queue_max,
        deadline_ms=args.deadline_ms, warm_max_rows=args.warm_max_rows,
        raw_score=args.raw_score, metrics_port=args.metrics_port)
    try:
        health = server.health()
        if args.probe:
            print(json.dumps(health, indent=1, sort_keys=True, default=str))
            return 0 if health["ready"] else 1
        sys.stderr.write(
            f"[serve] ready={health['ready']} warm_rungs="
            f"{health['warm_rungs']}; reading CSV rows from stdin\n")
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            row = np.array([float(t) for t in line.split(",")],
                           np.float64)
            out = server.predict(row.reshape(1, -1))
            val = np.asarray(out).ravel()
            print(",".join(f"{v:.10g}" for v in val), flush=True)
        return 0
    finally:
        server.close(drain=True)
        sys.stderr.write(f"[serve] stats: {json.dumps(server.stats)}\n")


if __name__ == "__main__":
    sys.exit(main())
