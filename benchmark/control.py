"""The correctness check's control and planted faults: runs of a cell with
the program or its input broken once set-up is done, each of which the
check must find (`correct` false).  The benchmark's own runs never run
this.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds 11 12 13 [--faults witness msm_half ntt_unchanged byte]

witness        the control: the circuit's `break_witness` breaks a
               guarantee the configuration states (lookup_heavy: one
               row's acc is x0 + x1 x2 + 1)
msm_half       the MSM layer's fixed-base calls drop the second half of
               their scalars
ntt_unchanged  lagrange_to_coeff returns its input unchanged
byte           one byte of every proof altered where it is produced
Prints one JSON line a run; exits 0 only where every run came out not
correct."""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("witness", "msm_half", "ntt_unchanged", "byte")


def install(fault: str, circuit, program, seed: int):
    """Plants `fault`; returns the function that takes it out.  The
    control breaks the witness by the circuit's own
    `program.break_witness`."""
    from halo2_tpu_torch import api, engine
    from halo2_tpu_torch.poly import domain
    from halo2_tpu_torch.poly.poly import Poly, take

    undo = []

    def patch(owner, attr, new):
        undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, new)

    if fault == "witness":
        return program.break_witness(circuit, random.Random(
            f"control:{seed}"))
    if fault == "msm_half":
        orig = engine.GpuMsmEngine.__dict__["msm_with_cached_base"]

        def half(self, curve, coeffs, base_desc):
            coeffs = coeffs.clone()
            coeffs[coeffs.shape[0] // 2:] = 0
            return orig(self, curve, coeffs, base_desc)
        patch(engine.GpuMsmEngine, "msm_with_cached_base", half)
    elif fault == "ntt_unchanged":
        def unchanged(self, a):
            a, typed = take(a, "lagrange", "lagrange_to_coeff")
            return Poly.coeff(a.clone()) if typed else a.clone()
        patch(domain.EvaluationDomain, "lagrange_to_coeff", unchanged)
    elif fault == "byte":
        orig = api.create_proof

        def altered(*args, **kwargs):
            proof = bytearray(orig(*args, **kwargs))
            proof[len(proof) // 2] ^= 0x01
            return bytes(proof)
        patch(api, "create_proof", altered)
    else:
        raise ValueError(f"unknown fault {fault!r}")

    def restore():
        for owner, attr, was in reversed(undo):
            setattr(owner, attr, was)
    return restore


def run_fault(workload: str, seed: int, seconds: float, fault: str,
              t_start: float, device: str = "cuda", root: str = ROOT):
    """One harness run with `fault` planted; the result's checks."""
    from benchmark import harness
    restore = []

    def plant(circuit, program):
        restore.append(install(fault, circuit, program, seed))
    try:
        res = harness.run(workload, seed, seconds, False, t_start,
                          device=device, root=root, patch_program=plant)
    finally:
        for r in restore:
            r()
    checks = res["checks"]
    return {"fault": fault, "seed": seed,
            "correct": checks["rejected"] == 0 and checks["checked"] >= 1,
            "rejected": checks["rejected"], "checked": checks["checked"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=list(FAULTS),
                    choices=FAULTS)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.run import use_checkout_caches
    use_checkout_caches()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    caught = True
    for fault in args.faults:
        for seed in args.seeds:
            out = run_fault(args.workload, seed, args.seconds, fault,
                            time.perf_counter())
            print(json.dumps(out), flush=True)
            caught &= not out["correct"]
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
