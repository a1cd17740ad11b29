"""Migrate a reference PyTorch checkpoint into the port: ``python -m
tsue_tpu_torch.cli import_ref [flags]`` (the port's
``scripts/import_reference_ckpt.py``).

The reference's stage-1 MLLM artifact (``mllm_lora_ddp_finetuned.pt``, a
state dict of its LlamaMultiModal) becomes the directory that ``train
--mllm-ckpt`` reads:

    python -m tsue_tpu_torch.cli import_ref \\
        --torch-ckpt mllm_lora_ddp_finetuned.pt --out runs/mllm_imported
    python -m tsue_tpu_torch.cli train --mllm-ckpt runs/mllm_imported

--strip-lora loads it into a Llama without LoRA (the no-LoRA ablation,
ref scripts/ablation_study_without_lora.py:1070-1084).  --stage2 takes a
whole stage-2 ``MultiModalTrajectoryModel`` state dict (saved at ref
scripts/train.py:1219-1224) into the directory that ``test --ckpt``,
``serve --ckpt`` and ``Predictor.from_checkpoint`` read:

    python -m tsue_tpu_torch.cli import_ref --stage2 \\
        --torch-ckpt best_val_checkpoint.pt --preset train_18_30 \\
        --out runs/ref_stage2
    python -m tsue_tpu_torch.cli test --preset train_18_30 \\
        --ckpt runs/ref_stage2 --tokenizer <the Llama-3.2 tokenizer>

The model is the preset's (its vocabulary the reference's 128256), built
on the CUDA device unless --device cpu, in fp32 as the file holds it.
The file is read with ``torch.load(weights_only=True)``; every key must
map to a parameter and every parameter must be filled, with its shape,
or the command raises before it writes."""
from __future__ import annotations

import time

from tsue_tpu_torch.cli._common import apply_overrides, base_parser, finish


def import_reference(cfg, torch_ckpt: str, out: str, stage2: bool = False,
                     strip_lora: bool = False, device="cuda") -> dict:
    """Convert the reference file ``torch_ckpt`` for the model ``cfg``
    names and write the port's artifact to ``out``; returns the command's
    result."""
    import dataclasses
    import torch
    from tsue_tpu_torch.convert import load_flax_params
    from tsue_tpu_torch.models import torch_import as ti
    from tsue_tpu_torch.runner import resolve_device
    from tsue_tpu_torch.train.checkpoint import export_mllm, save_state_dict

    dev = resolve_device(device)
    t0 = time.perf_counter()
    sd = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
    t_load = time.perf_counter() - t0
    consumed: set = set()
    m = cfg.model
    if stage2:
        from tsue_tpu_torch.models.tsue import TrajectoryModel
        tree = ti.convert_reference_stage2(sd, m, consumed)
        ti.check_consumed(sd, consumed)
        with torch.device(dev):
            model = TrajectoryModel(m, cfg.data.seq_len, cfg.data.out_len)
        save = save_state_dict
    else:
        from tsue_tpu_torch.models.fusion import MultiModalLLM
        llama = m.llama
        if strip_lora:
            llama = dataclasses.replace(llama, use_lora=False)
        tree = ti.convert_reference_mllm(sd, m.qformer, llama, consumed)
        ti.check_consumed(sd, consumed)
        if strip_lora:
            tree = ti.strip_lora_tree(tree)
        with torch.device(dev):
            model = MultiModalLLM(llama, m.qformer, m.use_vision)
        save = export_mllm
    load_flax_params(model, tree)
    t_convert = time.perf_counter() - t0 - t_load
    save(model, out)
    return {"out": out, "stage2": stage2, "keys": len(sd),
            "params": sum(p.numel() for p in model.parameters()),
            "load_s": t_load, "convert_s": t_convert,
            "save_s": time.perf_counter() - t0 - t_load - t_convert}


def main(argv=None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--torch-ckpt", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--strip-lora", action="store_true")
    p.add_argument("--stage2", action="store_true",
                   help="checkpoint is a full stage-2 model state_dict "
                        "(ref train.py:1219-1224), not the stage-1 MLLM")
    p.add_argument("--preset", default="train_18_30",
                   help="preset giving the horizons/model config the "
                        "checkpoint was trained with")
    args = p.parse_args(argv)
    from tsue_tpu_torch.config import get_preset
    cfg = apply_overrides(get_preset(args.preset), args)
    return finish(import_reference(cfg, args.torch_ckpt, args.out,
                                   args.stage2, args.strip_lora,
                                   args.device))


if __name__ == "__main__":
    main()
