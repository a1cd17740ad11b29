"""Fast-vs-parity K-candidate eval study: ``python -m tsue_tpu_torch.cli
study_fast_vs_parity [--epochs 30] [--seeds 5] [--k 10]`` (the port's
``scripts/study_fast_vs_parity.py``).

The reference's K candidates come from ``model.train()`` inside
``no_grad``: dropout is active in the whole model, LoRA dropout in the
Llama and the Q-Former's included.  The "parity" candidate mode
reproduces that (K whole stochastic forwards); the "fast" mode computes
the MLLM context deterministically once a batch and samples only the
forecaster's dropout.  The study trains the mid-size stack
(``_common.midsize_cfg``) jointly, so the Q-Former and the LoRA adapters
are trained and their dropout has an effect to measure, on the synthetic
highway set; then it evaluates min ADE / FDE / RMSE at K candidates in
both modes over ``--seeds`` eval seeds (seed s: ``5000 + 977 s``), prints
mean and std side by side as a markdown table, writes
``<out_dir>/<name>/study.json`` (the JAX script's layout: ``k``, ``seeds``,
``epochs``, ``summary`` of each metric's ``fast_mean``, ``fast_std``,
``parity_mean``, ``parity_std`` (numpy's population std) and
``delta_pct``, and ``raw``) and prints it as one JSON line.

``--tiny`` takes the tiny Llama and Q-Former for CPU runs (``--device
cpu``); the other preset flags apply as in every command."""
from __future__ import annotations

import json
import os
import time

import numpy as np

from tsue_tpu_torch.cli._common import (apply_overrides, base_parser,
                                        finish, midsize_cfg)

METRICS = ("minADE", "minFDE", "minRMSE")


def parser():
    """The JAX script's flags (``base_parser``'s, ``--k``, ``--seeds``)."""
    p = base_parser(__doc__)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--seeds", type=int, default=5)
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from tsue_tpu_torch.runner import evaluate, rebuild_for_eval, run_stage2
    cfg = apply_overrides(midsize_cfg("study_fast_vs_parity", "joint"), args)
    epochs = args.epochs if args.epochs is not None else 30
    print(f"training mid-size stack jointly for {epochs} epochs...")
    t0 = time.perf_counter()
    run_stage2(cfg, args.data, args.out_dir, epochs=epochs,
               eval_candidates=0, save_viz=False,
               synthetic_tracks=args.synthetic_tracks,
               tokenizer_path=args.tokenizer, device=args.device)
    t_train = time.perf_counter() - t0
    # the same seeds rebuild the split and windows run_stage2 trained on
    model, (_, _, dte) = rebuild_for_eval(
        cfg, args.data, args.out_dir, tokenizer_path=args.tokenizer,
        synthetic_tracks=args.synthetic_tracks, device=args.device)
    results = {"fast": [], "parity": []}
    for mode in ("fast", "parity"):
        for s in range(args.seeds):
            m = evaluate(model, dte, cfg, eval_candidates=args.k,
                         candidate_mode=mode, eval_seed=5000 + 977 * s)
            results[mode].append([m["min_ade"], m["min_fde"], m["min_rmse"]])
            print(f"  {mode:6s} seed {s}: minADE={m['min_ade']:.3f} "
                  f"minFDE={m['min_fde']:.3f} minRMSE={m['min_rmse']:.3f}")
    # numpy's population std, as the JAX script takes it
    summary = {}
    for j, name in enumerate(METRICS):
        f = np.array([r[j] for r in results["fast"]])
        q = np.array([r[j] for r in results["parity"]])
        summary[name] = {
            "fast_mean": float(f.mean()), "fast_std": float(f.std()),
            "parity_mean": float(q.mean()), "parity_std": float(q.std()),
            "delta_pct": float(100.0 * (f.mean() - q.mean()) / q.mean())}
    print(f"\n| metric | fast (mean+/-std, {args.seeds} seeds) | parity "
          f"(mean+/-std) | delta (% of parity) |")
    print("|---|---|---|---|")
    for name, v in summary.items():
        print(f"| {name} | {v['fast_mean']:.3f} +/- {v['fast_std']:.3f} "
              f"| {v['parity_mean']:.3f} +/- {v['parity_std']:.3f} "
              f"| {v['delta_pct']:+.2f}% |")
    study = {"k": args.k, "seeds": args.seeds, "epochs": epochs,
             "summary": summary, "raw": results}
    out_path = os.path.join(args.out_dir, cfg.name, "study.json")
    with open(out_path, "w") as fp:
        json.dump(study, fp, indent=1)
    print(f"\nwrote {out_path}")
    print(f"study wall time: {time.perf_counter() - t0:.1f}s (run_stage2 "
          f"{t_train:.1f}s)")
    return finish(study)


if __name__ == "__main__":
    main()
