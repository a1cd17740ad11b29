"""Export a checkpoint of the port to the reference's PyTorch state-dict
format: ``python -m tsue_tpu_torch.cli export_ref [flags]`` (the port's
``scripts/export_reference_ckpt.py``), the inverse of ``import_ref``.

The stage-1 MLLM artifact (the ``stage1`` command's --export) becomes the
``mllm_lora_ddp_finetuned.pt`` layout that the reference loads with
``strict=True`` (ref scripts/train.py:1137-1138):

    python -m tsue_tpu_torch.cli export_ref --ckpt runs/mllm \\
        --out mllm_lora_ddp_finetuned.pt

--stage2 exports a ``train`` checkpoint (a frozen regime's best artifact
holds only the trainable subset: the rest is rebuilt from the seed, and
from --mllm-ckpt where training imported one, as ``test --ckpt`` rebuilds
it) to the reference's ``MultiModalTrajectoryModel`` state dict (ref
scripts/train.py:1219-1224):

    python -m tsue_tpu_torch.cli export_ref --stage2 \\
        --ckpt runs/train_18_30/ckpt/best --preset train_18_30 \\
        --out best_val_checkpoint.pt

The model is rebuilt as the command that wrote the checkpoint built it
(the vocabulary the tokenizer's, --tokenizer), on the CUDA device unless
--device cpu; the file holds fp32 tensors."""
from __future__ import annotations

import time
from typing import Optional

from tsue_tpu_torch.cli._common import apply_overrides, base_parser, finish


def export_reference(cfg, ckpt: str, out: str, stage2: bool = False,
                     mllm_ckpt: Optional[str] = None, device="cuda",
                     tokenizer_path: Optional[str] = None) -> dict:
    """Rebuild the model of the port's checkpoint ``ckpt`` and write its
    reference-layout state dict to ``out``; returns the command's
    result."""
    import torch
    from tsue_tpu_torch.convert import flax_params
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.models import torch_export as te
    from tsue_tpu_torch.runner import (_check_restore_meta, _vocab_resized,
                                       build_model_and_params,
                                       resolve_device)
    from tsue_tpu_torch.train.checkpoint import load_state_dict, restore_merge

    dev = resolve_device(device)
    tokenizer = get_tokenizer(tokenizer_path)
    t0 = time.perf_counter()
    if stage2:
        _check_restore_meta(ckpt, mllm_ckpt)
        model = build_model_and_params(cfg, tokenizer, dev, mllm_ckpt)
        restore_merge(ckpt, model)
        export = te.export_reference_stage2
    else:
        from tsue_tpu_torch.models.fusion import MultiModalLLM
        if not cfg.model.use_vision:
            # the reference's stage-1 artifact always carries the
            # Q-Former and vision weights (ref scripts/train.py:1137-1138)
            raise SystemExit(
                f"preset {cfg.name!r} has use_vision=False: its MLLM "
                "checkpoints have no vision weights for the reference's "
                "stage-1 layout")
        with torch.device(dev):
            model = MultiModalLLM(_vocab_resized(cfg.model.llama, tokenizer),
                                  cfg.model.qformer)
        load_state_dict(model, ckpt)
        export = te.export_reference_mllm
    t_load = time.perf_counter() - t0
    exported = te.to_torch_state_dict(export(flax_params(model)))
    t_convert = time.perf_counter() - t0 - t_load
    torch.save(exported, out)
    return {"out": out, "stage2": stage2, "keys": len(exported),
            "load_s": t_load, "convert_s": t_convert,
            "save_s": time.perf_counter() - t0 - t_load - t_convert}


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint dir of the port (state.pt)")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--stage2", action="store_true",
                   help="checkpoint is a stage-2 TrajectoryModel artifact "
                        "(else: a stage-1 MLLM artifact)")
    p.add_argument("--preset", default="train_18_30",
                   help="preset giving the model config the checkpoint "
                        "was trained with")
    p.add_argument("--mllm-ckpt", default=None,
                   help="stage-1 MLLM artifact the stage-2 training "
                        "imported (frozen-regime checkpoints omit the "
                        "frozen subset)")
    args = p.parse_args(argv)
    from tsue_tpu_torch.config import get_preset
    cfg = apply_overrides(get_preset(args.preset), args)
    return finish(export_reference(cfg, args.ckpt, args.out, args.stage2,
                                   args.mllm_ckpt, args.device,
                                   args.tokenizer))


if __name__ == "__main__":
    main()
