"""DDPM trajectory generator: ``python -m tsue_tpu_torch.cli diffusion
[flags]`` (the port's ``scripts/capstone.py``, ref
modify_scripts/capstone_project.py; preset "mllm_free_18_18").  ``--mode
generate`` trains the conditional UNet and samples ``--samples`` guided
chains of ``--timesteps`` steps; ``--mode predict`` evaluates a stage-2
checkpoint (``--ckpt``) as the ``test`` command does."""
from __future__ import annotations

from tsue_tpu_torch.cli._common import apply_overrides, base_parser, finish


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--mode", default="generate",
                   choices=("generate", "predict"))
    p.add_argument("--ckpt", default=None)
    p.add_argument("--mllm-ckpt", default=None,
                   help="stage-1 MLLM artifact the checkpoint was trained "
                        "with (predict mode; required when training used "
                        "--mllm-ckpt)")
    p.add_argument("--cfg-scale", type=float, default=3.0)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--samples", type=int, default=5)
    args = p.parse_args(argv)
    from tsue_tpu_torch.config import get_preset
    cfg = apply_overrides(get_preset("mllm_free_18_18"), args)
    if args.mode == "generate":
        from tsue_tpu_torch.runner import run_diffusion
        return finish(run_diffusion(cfg, args.data, args.out_dir,
                                    epochs=args.epochs,
                                    cfg_scale=args.cfg_scale,
                                    n_timestep=args.timesteps,
                                    n_samples=args.samples,
                                    synthetic_tracks=args.synthetic_tracks,
                                    device=args.device))
    from tsue_tpu_torch.runner import run_stage2
    return finish(run_stage2(cfg, args.data, args.out_dir,
                             mllm_ckpt=args.mllm_ckpt, epochs=0,
                             restore_ckpt=args.ckpt,
                             synthetic_tracks=args.synthetic_tracks,
                             tokenizer_path=args.tokenizer,
                             device=args.device))


if __name__ == "__main__":
    main()
