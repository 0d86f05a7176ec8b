"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs a CUDA card (it never falls back to the CPU).  Build and kernel
caches stay in fixed directories inside the checkout: the port's nvcc
builds in `halo2_tpu_torch/_build/`, Triton's and the IPA parameters'
caches under `.bench_cache/`.  The last lines of standard error, and the
result's last key, give each number the correctness check compared beside
its limit."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def use_checkout_caches():
    """Triton's cache and the port's IPA parameters in fixed directories
    of the checkout, and the checkout on the import path."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["HALO2_TPU_CACHE"] = os.path.join(CACHE, "halo2_tpu")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    use_checkout_caches()
    import torch
    from benchmark import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA card is visible: the benchmark runs only on one",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    return emit(result, torch.cuda.get_device_name(0))


def emit(result: dict, device_name: str) -> int:
    """Prints the result line, unless JAX or the JAX package is loaded in
    this process by now: then it names them on standard error and fails."""
    from benchmark import jaxcheck
    line = result_line(result, device_name)
    found = jaxcheck.forbidden_loaded()
    if found:
        print(f"JAX or the JAX package is loaded: {found}; no result",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


def result_line(result: dict, device_name: str) -> dict:
    """The contract's last line; the numbers compared go last, and to
    standard error as its last lines."""
    checks = result["checks"]
    compared = {"rejected_proofs": {"value": checks["rejected"], "limit": 0},
                "checked_proofs": {"value": checks["checked"],
                                   "limit": "at least 1"}}
    correct = checks["rejected"] == 0 and checks["checked"] >= 1
    device = {"platform": "gpu", "kind": device_name, "count": 1,
              "memory_peak_bytes": result["peak"]}
    if "busy_s" in result:
        device.update(busy_s=result["busy_s"], window_s=result["window_s"])
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": checks["rejected"], "metrics": result["metrics"],
            "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = compared
    print(f"compared rejected_proofs={checks['rejected']} (limit 0)",
          file=sys.stderr)
    print(f"compared checked_proofs={checks['checked']} (limit: at least 1)",
          file=sys.stderr, flush=True)
    return line


if __name__ == "__main__":
    sys.exit(main())
