"""Stage-2 TSUE trainer: ``python -m tsue_tpu_torch.cli train [flags]``
(the port's ``scripts/train.py``: 18->30, frozen MLLM by default).  Under
torchrun every rank trains its rows of each batch (``--model-parallel N``:
tensor-parallel groups of N ranks; ``--fsdp``: FSDP over the data axis);
rank 0 writes."""
from __future__ import annotations

from tsue_tpu_torch.cli._common import (add_mesh_args, apply_overrides,
                                        base_parser, check_mesh_args, finish,
                                        setup_mesh, with_mesh)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--preset", default="train_18_30")
    p.add_argument("--mllm-ckpt", default=None,
                   help="stage-1 MLLM artifact (the stage1 command's "
                        "--export)")
    p.add_argument("--viz-every", type=int, default=0,
                   help="every N epochs: one val-sample plot and one "
                        "generated context paragraph (matplotlib for the "
                        "plot)")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint the full train state every N epochs "
                        "(enables --resume)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the last --save-every state; the "
                        "continued run equals an uninterrupted one")
    add_mesh_args(p)
    args = p.parse_args(argv)
    check_mesh_args(p, args)
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.runner import run_stage2
    cfg = with_mesh(apply_overrides(get_preset(args.preset), args), args)
    mesh = setup_mesh(args)
    return finish(run_stage2(cfg, args.data, args.out_dir, args.mllm_ckpt,
                             args.epochs,
                             synthetic_tracks=args.synthetic_tracks,
                             viz_every=args.viz_every,
                             save_every=args.save_every, resume=args.resume,
                             tokenizer_path=args.tokenizer,
                             device=args.device, mesh=mesh))


if __name__ == "__main__":
    main()
