"""``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the card, its result as the last
line of standard output and the compared numbers, each beside its limit,
as the last lines of standard error."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

from harness.spec import PACKAGE, ROOT

PROGRAM = "moonrtx_tpu_torch"
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"MOONRTX_TPU_CACHE": "maps",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton"}


def fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def setup_checkout() -> None:
    """Point every cache at its fixed directory inside the checkout and put
    the checkout's root on the import path (before torch is imported)."""
    for var, sub in CACHES.items():
        path = ROOT / PACKAGE / ".cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    if str(ROOT) not in sys.path:
        sys.path.insert(1, str(ROOT))


def main(argv=None, t_start: float = 0.0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / PROGRAM).is_dir():
        return fail(f"the program ({PROGRAM}) is not in this checkout", 2)
    setup_checkout()
    import torch

    from harness import cell, spec

    try:
        chips = spec.workload(spec.load_benchmark(), args.workload)["chips"]
    except KeyError as e:
        return fail(str(e), 2)
    if not torch.cuda.is_available():
        return fail("no CUDA device is available", 3)
    if torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} cards, this host has "
                    f"{torch.cuda.device_count()}", 3)
    print(f"# card: {card_line()} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    try:
        result = cell.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start)
    except Exception:
        traceback.print_exc()
        return fail("the run failed", 1)
    found = cell.forbidden_modules(list(sys.modules))
    if found:
        return fail("loaded in this process: " + ", ".join(found), 4)
    checks = result["checks"]
    for k, c in checks.items():
        if k != "requests_compared":
            print(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})",
                  file=sys.stderr)
    print(f"check requests_compared: {checks['requests_compared']['value']} "
          f"(at least 1)", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
