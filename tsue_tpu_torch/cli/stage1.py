"""Stage-1 MLLM trainer and generation eval: ``python -m
tsue_tpu_torch.cli stage1 [flags]`` (the port's
``scripts/check_generation.py``, the training loop included).  Writes
test_generation_results.txt and, with --export, the MLLM artifact for the
train command's --mllm-ckpt."""
from __future__ import annotations

from tsue_tpu_torch.cli._common import (apply_overrides, base_parser, finish,
                                        refuse_not_ported)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--export", default=None,
                   help="export the trained MLLM parameters to this dir")
    p.add_argument("--pipeline-parallel", type=int, default=None,
                   help="pipeline stages over the Llama decoder depth (not "
                        "ported yet: raises when > 1)")
    p.add_argument("--microbatches", type=int, default=None,
                   help="pipeline microbatch upper bound")
    args = p.parse_args(argv)
    refuse_not_ported(args)
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.runner import run_stage1
    cfg = apply_overrides(get_preset("train_18_30"), args)
    return finish(run_stage1(cfg, args.data, args.out_dir, epochs=args.epochs,
                             export_path=args.export,
                             synthetic_tracks=args.synthetic_tracks,
                             generation_dump="test_generation_results.txt",
                             tokenizer_path=args.tokenizer,
                             device=args.device))


if __name__ == "__main__":
    main()
