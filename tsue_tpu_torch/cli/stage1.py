"""Stage-1 MLLM trainer and generation eval: ``python -m
tsue_tpu_torch.cli stage1 [flags]`` (the port's
``scripts/check_generation.py``, the training loop included).  Writes
test_generation_results.txt and, with --export, the MLLM artifact for the
train command's --mllm-ckpt.  With --pipeline-parallel N > 1 it runs
under torchrun (``python -m torch.distributed.run --nproc_per_node W -m
tsue_tpu_torch.cli stage1 --pipeline-parallel N ...``; N divides W): NCCL
on the card, gloo with --device cpu."""
from __future__ import annotations

from tsue_tpu_torch.cli._common import apply_overrides, base_parser, finish


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--export", default=None,
                   help="export the trained MLLM parameters to this dir")
    p.add_argument("--pipeline-parallel", type=int, default=None,
                   help="GPipe stages over the Llama decoder depth (must "
                        "divide the world size; launch with torchrun)")
    p.add_argument("--microbatches", type=int, default=None,
                   help="pipeline microbatch upper bound")
    args = p.parse_args(argv)
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
