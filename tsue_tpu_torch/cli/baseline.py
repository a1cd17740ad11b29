"""Comparison baselines: ``python -m tsue_tpu_torch.cli baseline --name
NAME [flags]`` (the port's ``scripts/baseline_*.py`` and
``scripts/test_baseline_*.py``, preset "ablation_no_llm", 6->30).  NAME is
one of cv, cs_lstm, social_lstm, stgcnn, trajectron, mmtrans, gail;
``--k K`` adds the K-candidate eval (cv takes 10 when K is 0)."""
from __future__ import annotations

from tsue_tpu_torch.cli._common import apply_overrides, base_parser, finish
from tsue_tpu_torch.models.baselines import BASELINE_NAMES


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--name", required=True, choices=BASELINE_NAMES)
    p.add_argument("--k", type=int, default=0,
                   help="K-candidate eval (ref test_baseline_* scripts)")
    args = p.parse_args(argv)
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.runner import run_baseline
    cfg = apply_overrides(get_preset("ablation_no_llm"), args)
    return finish(run_baseline(args.name, cfg, args.data, args.out_dir,
                               epochs=args.epochs, eval_candidates=args.k,
                               synthetic_tracks=args.synthetic_tracks,
                               device=args.device))


if __name__ == "__main__":
    main()
