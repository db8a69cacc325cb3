"""Run one cell of the benchmark once and print its result line.

    python3 fmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the repository root, on a machine with a CUDA card.  The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared with its limit).  The checks are also the
last lines of standard error.  Without a card, without the program, or
with JAX loaded once the window has closed, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "awry_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit (nvidia-smi)."""
    import torch

    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import torch

        import awry_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"fmbench: cannot import the program: {e}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("fmbench: no CUDA device; a run measures the card only", file=sys.stderr)
        return 2
    from fmbench.harness import run_cell

    print(f"fmbench: {args.workload} seed {args.seed} on {torch.cuda.get_device_name(0)}", file=sys.stderr,
          flush=True)
    out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    dev = card()  # after the window: nvidia-smi is no part of set-up
    print(f"fmbench: power limit {dev['power_limit_w']} W", file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"fmbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    out["device"].update(kind=dev["kind"], power_limit_w=dev["power_limit_w"])
    checks = out.pop("checks")
    out["checks"] = checks  # the last key of the line
    for name, c in checks.items():
        print(f"check {name}: {c['value']} {'>=' if 'min' in c else '<='} {c.get('min', c.get('max'))}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
