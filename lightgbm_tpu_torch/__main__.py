"""``python -m lightgbm_tpu_torch config=train.conf [key=value ...]``: the
command line of ``cli.py`` (reference: LightGBM's src/main.cpp)."""
from .cli import run

if __name__ == "__main__":
    raise SystemExit(run())
