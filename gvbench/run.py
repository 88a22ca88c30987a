"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 -m gvbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It makes the cell's weights and inputs from the seed, sets up and
warms the program, measures for --seconds, checks what the window served
against the float32 reference, and prints one JSON line last on standard
output (with --trace 0 the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, the device's busy time and a breakdown). The numbers
compared with their limits are printed last on standard error and, under
"checks", last in the line. It exits 2 without a result where there is no
CUDA card or too few, 3 where a module of JAX or of the JAX package is
loaded once the window has closed, and 1 with every thread's stack where
the run has not ended after WATCHDOG_S seconds.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WATCHDOG_S = 340


def set_environment() -> None:
    """Build caches inside the checkout, at fixed paths; no JAX from any
    library the program loads."""
    cache = ROOT / "build" / "gvbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a run that has not ended by then prints every thread's stack and
    # exits 1, rather than hang the card
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    set_environment()
    sys.path.insert(0, str(ROOT))
    import torch

    from gvbench import harness

    bench = harness.benchmark()
    cell = harness.cell(args.workload, bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gvbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        return 2
    conf = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    result = harness.driver(mix["driver"]).run_cell(
        cell, conf, mix, args.seed, args.seconds, bool(args.trace), "cuda",
        T_PROCESS, bench, harness.limits(args.workload))
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"gvbench: the process holds {', '.join(found)} after the "
              "window", file=sys.stderr)
        return 3
    print_card()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


def print_card() -> None:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi: {e}"
    print(f"[card] {out}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
