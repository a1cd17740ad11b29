"""The port's command-line entry points.

    python -m tsue_tpu_torch.cli <command> [flags]

with one module per command, each exposing ``main(argv) -> dict`` that
prints its result as one JSON line:

- ``train``: stage-2 training (``scripts/train.py``);
- ``stage1``: stage-1 MLLM fine-tuning and the generation dump
  (``scripts/check_generation.py``);
- ``test``: the K-candidate eval of a checkpoint (``scripts/test.py``;
  ``--preset test_6_12`` is ``scripts/test_10.py``);
- ``serve``: batch JSONL predictions or generations, or the HTTP API
  (``scripts/serve.py``);
- ``baseline``: one of the seven comparison baselines trained and scored
  (``scripts/baseline_*.py``, ``scripts/test_baseline_*.py``);
- ``diffusion``: the DDPM trajectory generator, or the eval of a stage-2
  checkpoint (``scripts/capstone.py``);
- ``quality_quant``: the quantised decode's quality against the bf16
  baseline at Llama-3.2-1B's widths (``scripts/quality_quant.py``);
- ``params``: parameter counts per freeze regime (``scripts/check.py``);
- ``roi_map``: the lane-ROI polygon map (``scripts/graph.py``);
- ``plot``: test-split predictions over the lane map, and the map
  (``scripts/plot.py``);
- ``import_ref``: the reference's own PyTorch checkpoint, stage 1 or
  (``--stage2``) the whole model, into the port's artifact
  (``scripts/import_reference_ckpt.py``);
- ``export_ref``: a checkpoint of the port into the reference's state-dict
  layout (``scripts/export_reference_ckpt.py``);
- ``study_fast_vs_parity``: the mid-size stack trained jointly, then K=10
  min ADE / FDE / RMSE of the fast and the parity candidate modes over
  several eval seeds (``scripts/study_fast_vs_parity.py``);
- ``study_speculative_acceptance``: the mid-size byte MLLM trained with
  stage 1, then plain against speculative greedy decoding, timed, with
  the tokens a forward (``scripts/study_speculative_acceptance.py``).

Every command that runs a model runs it on the CUDA device unless given
``--device cpu``.
"""
COMMANDS = ("train", "stage1", "test", "serve", "baseline", "diffusion",
            "quality_quant", "params", "roi_map", "plot", "import_ref",
            "export_ref", "study_fast_vs_parity",
            "study_speculative_acceptance")
