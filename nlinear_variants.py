#!/usr/bin/env python3
"""Time launch variants of the NLinear kernel side by side on one GPU.

    python3 nlinear_variants.py [--out build/nlinear_variants.json]
                                [--old-source FILE]

Each variant is ``tsue_tpu_torch/csrc/nlinear.cu`` launched through
``ops/nlinear.py:_launch`` with a plan other than ``nlinear_plan``'s: the
other copy form, other rows (bb) or channels (cg) a CTA.  Every variant is
timed at chip_smoke.py's three NLinear shapes (B 16 and 160 at 18 -> 18, B
16 at 18 -> 30; C = 64) with chip_smoke.py's timer (L2 flushed, median of
15), in two rounds, the second in reverse order, so a drift of the card
does not favour one variant:

  plan           nlinear_plan's launch (the bulk form, cg 2, bb 4)
  cp4            the same layout, staged by 4-byte cp.async copies
  bb1 .. bb16    the bulk form with 1, 2, 8 or 16 rows a CTA
  cg4, cg4_bb2   the bulk form with 4 channels a CTA (4 or 2 rows)
  cp4_bb8        the 4-byte form with 8 rows a CTA

``--old-source FILE`` also builds FILE, an earlier ``nlinear.cu`` with the
earlier C entry ``nlinear(x, w, bias, out, B, C, Ti, To, stream)``, and
times it as the variant ``old``.  The timer's launch floor, the plain
version and the einsum alone are timed beside.  Every variant is held to
the plain version (chip_smoke.py's atol = rtol = 1e-4) and to the plan's
bits; one that differs is named, left untimed, and makes the script exit
1.  It needs a CUDA device and nvcc, and prints the card beside every
time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs

SHAPES = ((16, 64, 18, 18), (160, 64, 18, 18), (16, 64, 18, 30))
VARIANTS = {   # name: the plan's entries it changes
    "plan": {}, "cp4": {"form": "cp4"}, "bb1": {"bb": 1}, "bb2": {"bb": 2},
    "bb8": {"bb": 8}, "bb16": {"bb": 16}, "cg4": {"cg": 4},
    "cg4_bb2": {"cg": 4, "bb": 2}, "cp4_bb8": {"form": "cp4", "bb": 8},
}


def variant_plan(base: dict, change: dict, B: int, C: int, Ti: int,
                 To: int) -> dict:
    """``base`` with ``change``, its threads, CTAs and shared bytes
    counted as nlinear_plan counts them."""
    from tsue_tpu_torch.ops.nlinear import MAX_THREADS, _smem
    plan = {**base, **change}
    cg, bb = plan["cg"], plan["bb"]
    plan.update(threads=min(MAX_THREADS, -(-bb * cg * To // 32) * 32),
                ctas=-(-C // cg) * -(-B // bb),
                smem_bytes=_smem(Ti, To, cg, bb))
    return plan


def build_old(path: Path, out_dir: Path):
    """Build an earlier source of the kernel; return its launch function."""
    import torch
    from tsue_tpu_torch.ops._build import build_variants
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib, _ = build_variants({"old": path.read_text()}, out_dir, {
        "nlinear": [ptr] * 4 + [i32] * 4 + [ptr]})["old"]

    def run(x, w, b):
        B, C, Ti = x.shape
        out = torch.empty(B, C, w.shape[2], device=x.device)
        cs.check(lib.nlinear(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), B, C, Ti, w.shape[2],
                             torch.cuda.current_stream().cuda_stream) == 0,
                 "the old kernel's launch failed")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the timings here as JSON")
    ap.add_argument("--old-source", type=Path, default=None,
                    help="an earlier nlinear.cu to time beside")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("nlinear_variants: no CUDA device", file=sys.stderr)
        return 1
    import tsue_tpu_torch.ops.nlinear as NL
    from tsue_tpu_torch.ops._build import BUILD_DIR, build
    gpu = cs.gpu_line()
    print(gpu, flush=True)
    for line in build("nlinear")[1].splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print("ptxas: " + line.strip(), flush=True)
    old = (build_old(args.old_source, BUILD_DIR / "nlinear_variants")
           if args.old_source else None)
    dev = torch.device("cuda:0")
    timer = cs.Timer(dev)
    print(f"launch_floor_ms {timer.floor_ms:.4f}; gpu: {gpu}", flush=True)
    g = torch.Generator(device=dev).manual_seed(6)
    report, wrong = {}, set()
    for B, C, Ti, To in SHAPES:
        label = f"B={B} C={C} {Ti}->{To}"
        x = torch.randn(B, C, Ti, generator=g, device=dev)
        w = torch.randn(C, Ti, To, generator=g, device=dev) * Ti ** -0.5
        b = torch.randn(C, To, generator=g, device=dev) * 0.1
        ref = NL.nlinear_ref(x, w, b)
        base = NL.nlinear_plan(B, C, Ti, To)
        runs = {}
        for name, change in VARIANTS.items():
            plan = variant_plan(base, change, B, C, Ti, To)

            def run(plan=plan, name=name):
                out = torch.empty(B, C, To, device=dev)
                cs.check(NL._launch(x, w, b, out, plan) == 0,
                         f"{name} {label}: launch failed ({plan})")
                return out
            runs[name] = (run, plan)
        if old is not None:
            runs["old"] = (lambda: old(x, w, b), None)
        first = runs["plan"][0]()
        for name, (run, plan) in runs.items():
            out = run()
            torch.cuda.synchronize()
            same = torch.equal(out, first)
            if not torch.allclose(out, ref, **cs.TOL) or not same:
                print(f"{name} {label}: differs (max abs err vs plain "
                      f"{(out - ref).abs().max().item()}, bits equal to the "
                      f"plan's: {same})", flush=True)
                wrong.add((name, label))
        times: dict = {}
        names = [n for n in runs if (n, label) not in wrong]
        for order in (names, names[::-1]):
            for name in order:
                times.setdefault(name, []).append(timer.ms(runs[name][0]))
        plain_ms = timer.ms(lambda: NL.nlinear_ref(x, w, b))
        einsum_ms = timer.ms(lambda: torch.einsum("bct,cto->bco", x, w))
        summary = {n: min(v) for n, v in times.items()}
        for name, ms in summary.items():
            print(f"{name} {label}: {ms:.4f} ms (plan {runs[name][1]}); "
                  f"gpu: {gpu}", flush=True)
        report[label] = dict(min_ms_of_two_rounds=summary, ms=times,
                             plain_ms=plain_ms, einsum_ms=einsum_ms,
                             plans={n: p for n, (_, p) in runs.items()})
        print(f"{label}: plain {plain_ms:.4f} ms, einsum alone "
              f"{einsum_ms:.4f} ms; gpu: {gpu}", flush=True)
    result = {"gpu": gpu, "launch_floor_ms": timer.floor_ms,
              "shapes": {k: v["min_ms_of_two_rounds"]
                         for k, v in report.items()}}
    print(json.dumps(result), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"gpu": gpu, "launch_floor_ms": timer.floor_ms,
             "shapes": report}, indent=1))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
