"""Parameter counts per freeze regime: ``python -m tsue_tpu_torch.cli
params [--regime frozen_mllm|joint|lora_only|full_freeze] [--no-llm]
[--tiny]`` (the port's ``scripts/check.py``; ref
modify_scripts/check.py:1350-1418).

Builds the TrajectoryModel of preset "train_18_30" on the ``meta`` device
(shapes only: the 1.2 B parameters take no memory) and prints the total,
per-group and trainable counts under the regime (``train.trainer.
freeze_label``), then one JSON line with the total and trainable counts.
"""
from __future__ import annotations

import dataclasses

from tsue_tpu_torch.cli._common import apply_overrides, base_parser, finish

REGIMES = ("frozen_mllm", "joint", "lora_only", "full_freeze")


def count_model_params(cfg, regime: str) -> dict:
    """``utils.debug.count_params`` of the config's TrajectoryModel, built
    on the ``meta`` device, split by ``freeze_label`` under ``regime``."""
    import torch
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.train.trainer import freeze_label
    from tsue_tpu_torch.utils.debug import count_params
    with torch.device("meta"):
        model = TrajectoryModel(cfg.model, cfg.data.seq_len,
                                cfg.data.out_len)
    return count_params(model, lambda s: freeze_label(s, regime))


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--regime", default="frozen_mllm", choices=REGIMES)
    p.add_argument("--no-llm", action="store_true")
    args = p.parse_args(argv)
    from tsue_tpu_torch.config import get_preset
    cfg = apply_overrides(get_preset("train_18_30"), args)
    if args.no_llm:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_llm=False))
    counts = count_model_params(cfg, args.regime)
    print(f"regime={args.regime}")
    for g, n in sorted(counts["groups"].items()):
        print(f"  {g:24s} {n / 1e6:10.2f} M")
    print(f"  {'TOTAL':24s} {counts['total'] / 1e6:10.2f} M")
    print(f"  {'trainable':24s} {counts['trainable'] / 1e6:10.2f} M")
    return finish({"total": counts["total"],
                   "trainable": counts["trainable"]})


if __name__ == "__main__":
    main()
