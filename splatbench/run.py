"""The benchmark of ``gsplat_tpu_torch``: one run of one cell on the card.

    python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration and traffic mix; ``--trace 0`` prints its end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  The last line
of standard output is the result as one JSON object; the numbers that
decided ``correct`` close standard error.  Without a CUDA card (or with
fewer than the cell asks for) it exits 2 and prints no result.  The port's
own prints go to standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result_out, sys.stdout = sys.stdout, sys.stderr
    from splatbench.harness import spec
    cell = spec.load(args.workload)
    cache = os.path.join(spec.PKG, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # the port reads its tile shape once, when it is imported
    os.environ["GSPLAT_TILE_X"] = os.environ["GSPLAT_TILE_Y"] = str(
        cell.config["tile"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"splatbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from splatbench.harness import bench
    card = card_line()
    print(f"splatbench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr)
    result = bench.run_cell(cell, args.seed, args.seconds, args.trace,
                            "cuda", T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"splatbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["card"] = card
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=result_out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
