"""K-candidate MC-dropout eval of a checkpoint: ``python -m
tsue_tpu_torch.cli test [flags]`` (the port's ``scripts/test.py``, 18->18;
``--preset test_6_12`` is ``scripts/test_10.py``).  Reports min ADE / FDE
/ RMSE over K candidates of the fast or the parity rollout.  Under
torchrun the ranks score their rows and report the global metrics
(``--model-parallel``, ``--fsdp`` as ``train``)."""
from __future__ import annotations

from tsue_tpu_torch.cli._common import (add_mesh_args, apply_overrides,
                                        base_parser, check_mesh_args, finish,
                                        setup_mesh, with_mesh)


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--preset", default="test_18_18")
    p.add_argument("--ckpt", default=None, help="trained checkpoint dir")
    p.add_argument("--mllm-ckpt", default=None,
                   help="stage-1 MLLM artifact the checkpoint was trained "
                        "with (required when training used --mllm-ckpt: "
                        "frozen-regime checkpoints omit the frozen subset)")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--candidate-mode", default="fast",
                   choices=("fast", "parity"))
    add_mesh_args(p)
    args = p.parse_args(argv)
    check_mesh_args(p, args)
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.runner import run_stage2
    cfg = with_mesh(apply_overrides(get_preset(args.preset), args), args)
    mesh = setup_mesh(args)
    return finish(run_stage2(cfg, args.data, args.out_dir,
                             mllm_ckpt=args.mllm_ckpt,
                             epochs=args.epochs or 0,
                             eval_candidates=args.k, restore_ckpt=args.ckpt,
                             synthetic_tracks=args.synthetic_tracks,
                             candidate_mode=args.candidate_mode,
                             tokenizer_path=args.tokenizer,
                             device=args.device, mesh=mesh))


if __name__ == "__main__":
    main()
