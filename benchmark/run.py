"""One run of one benchmark cell of the PyTorch port on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files (``BENCHMARK.json``, its configuration and traffic),
makes the weights and inputs on the card from the seed, warms the cell's
shapes, runs the timed window, checks what the window produced against the
plain reference, and prints one JSON result line last on standard output
(the compared numbers beside their limits last on standard error).  With
``--trace 1`` the first seconds of the window are profiled and the line
carries the per-layer metrics instead of the end-to-end ones.  Exits non-zero,
with no result, without enough cards, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark.harness.core import ROOT, forbidden_loaded, load_cell, result_line

    # caches of the libraries the port may use stay inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / "_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "benchmark" / "_cache" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # both configurations state float32: no TF32, for the port and the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    outcome = drive(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    line, checks = result_line(cell, outcome, bool(args.trace), torch.cuda.get_device_name(device))
    print(f"benchmark: {cell.name} seed {args.seed}: {outcome.extra}", file=sys.stderr)
    print(checks, file=sys.stderr)
    print(line, flush=True)
    return 0


def drive(cell, seed: int, seconds: float, trace: bool, device, t_start: float = None):
    """The cell's runner (``benchmark/harness/<entry>.py`` by its traffic's
    ``entry``) over one run."""
    from benchmark.harness.core import runner

    return runner(cell).run(cell, seed, seconds, trace, device,
                            T_START if t_start is None else t_start)


if __name__ == "__main__":
    sys.exit(main())
