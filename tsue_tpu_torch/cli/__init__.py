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
  (``scripts/serve.py``).

Every command runs on the CUDA device unless given ``--device cpu``.
"""
COMMANDS = ("train", "stage1", "test", "serve")
