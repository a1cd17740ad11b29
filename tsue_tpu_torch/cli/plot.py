"""Test trajectories over the lane-ROI map: ``python -m
tsue_tpu_torch.cli plot [--ckpt DIR] [--max-samples N] [--roi ...]
[flags]`` (the port's ``scripts/plot.py``; ref scripts/plot.py:1019-1078).

Walks the test split of the preset's data (synthetic tracks without
--data) in order through the deterministic forward of a ``Predictor``:
over a ``run_stage2`` checkpoint (``--ckpt``, with ``--mllm-ckpt`` when
its training imported a stage-1 MLLM) or, without one, over the random
weights ``runner.build_model_and_params`` draws.  Plots the past, the
ground truth and the prediction of up to ``--max-samples`` windows over
the map (``viz.plots.plot_trajectories_over_map``) and prints {"figure",
"samples"} as one JSON line.  The figure is drawn with matplotlib, which
the card's machine does not have: plot on the CPU (``--device cpu``).
"""
from __future__ import annotations

from tsue_tpu_torch.cli._common import (add_roi_args, apply_overrides,
                                        base_parser, finish, resolve_roi)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--preset", default="train_18_30")
    p.add_argument("--ckpt", default=None, help="run_stage2 checkpoint dir")
    p.add_argument("--mllm-ckpt", default=None,
                   help="stage-1 MLLM artifact the checkpoint was trained "
                        "with")
    p.add_argument("--max-samples", type=int, default=32)
    add_roi_args(p)
    args = p.parse_args(argv)
    import torch
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import BatchIterator, get_tokenizer
    from tsue_tpu_torch.runner import (build_model_and_params,
                                       prepare_data, to_device)
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train.losses import denorm
    from tsue_tpu_torch.viz.plots import plot_trajectories_over_map

    cfg = apply_overrides(get_preset(args.preset), args)
    tok = get_tokenizer(args.tokenizer)
    _, _, dte = prepare_data(cfg, args.data, tok, args.synthetic_tracks)
    if args.ckpt:
        pred = Predictor.from_checkpoint(cfg, args.ckpt,
                                         mllm_ckpt=args.mllm_ckpt,
                                         tokenizer=tok, device=args.device)
    else:
        model = build_model_and_params(cfg, tok, args.device)
        pred = Predictor(cfg.replace(model=model.cfg), model.state_dict(),
                         tokenizer=tok, device=args.device)
    samples = []
    for batch in BatchIterator(dte, 16, shuffle=False):
        b = to_device(batch, pred.device)
        with torch.inference_mode():
            out = pred.model(b)
        ns = b["norm_stat"]
        past, gt, pd = (denorm(t, ns).cpu().numpy()
                        for t in (b["traj_in"], b["traj_out"], out))
        for i in range(out.shape[0]):
            if batch["valid"][i] and len(samples) < args.max_samples:
                samples.append({"past": past[i], "gt": gt[i],
                                "pred": pd[i]})
        if len(samples) >= args.max_samples:
            break
    path = plot_trajectories_over_map(samples, resolve_roi(args),
                                      args.out_dir, site=args.site,
                                      zone=args.zone)
    return finish({"figure": path, "samples": len(samples)})


if __name__ == "__main__":
    main()
