#!/usr/bin/env python3
"""MAIN's iterations/s alone, for comparing two checkouts of the port.

Runs ``chip_smoke.phase_main_path`` (10.5M Higgs-shaped rows, 255 leaves,
255 bins, the compact grower, 1 warm-up and ``--rounds`` timed rounds,
``deterministic=False``) ``--repeats`` times in one process, from the
checkout at ``--root`` (its ``chip_smoke.py`` and ``lightgbm_tpu_torch``),
with K1's and K2's libraries built before the first run and no other
kernel build on the host. Prints the card's name and power limit, then
one JSON line a run and one with their iterations/s. Compare two commits
in one call on one card, in the order parent, change, change, parent:

    python3 scripts/torch_main_rate.py --root PARENT_CHECKOUT
    python3 scripts/torch_main_rate.py
"""
import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose chip_smoke.py and port to run")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_main_rate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch import _kernels
    assert Path(lgt.__file__).resolve().is_relative_to(root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    _kernels.build(["histogram", "fused_split"])
    rates = []
    for rep in range(args.repeats):
        results = {}
        chip_smoke.phase_main_path(lgt, args.rows, args.rounds, results)
        main = results["main"]
        rates.append(main["iterations_per_s"])
        print("RUN", json.dumps({"root": root, "repeat": rep,
                                 "iterations_per_s": rates[-1],
                                 "round_s": main["round_s"],
                                 "launches": main["launches"]}),
              flush=True)
        del results, main
        gc.collect()
        torch.cuda.empty_cache()
    print("RATES", json.dumps({"root": root, "iterations_per_s": rates}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
