"""The controls of a cell's comparison, at the cell's own size, on the card.

    python3 fmbench/control.py --workload <name> --seed <n> --seconds <s>

It makes one run of the cell as ``run.py`` does, and then puts each
control of ``check.CONTROLS`` (the reference with one guarantee broken) in
the program's place over the same returned batches and sampled lanes.  It
prints one JSON line: the run's own numbers compared and, per control, the
numbers the comparison reads.  A sound control reads above every limit;
the smallest reading over the seeds is the upper end a limit is set below.
The over-cap lanes of each sample are those the program's returned counts
put over ``cap`` (``harness.Sampler``), in the control's run as in every
run.  The benchmark's runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("fmbench: no CUDA device; the controls are read at the cell's size on the card", file=sys.stderr)
        return 2
    from fmbench.harness import run_cell

    out = run_cell(ROOT, args.workload, args.seed, args.seconds, False, "cuda", T_START, controls=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": out["correct"],
                      "checks": out["checks"], "controls": out["controls"], "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
