"""Configuration tree for TSUE-TPU.

The reference expresses every experiment as a whole-file copy with a hard-coded
``args`` dict in ``main()`` (ref scripts/train.py:1331-1366).  Here every
variant is a named preset over one dataclass tree; see ``PRESETS`` at the
bottom for the mapping to reference scripts (SURVEY.md §2.7).

This is the PyTorch port's own copy of ``tsue_tpu/config.py``: the port
imports nothing of the JAX package.  ``tests/test_torch_data.py`` holds the
two equal.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Sliding-window dataset build (ref scripts/train.py:114-259)."""
    seq_len: int = 18
    out_len: int = 30
    stride: int = 6
    downsample: int = 5
    max_step: float = 50.0
    max_speed_diff: float = 30.0
    min_range_x: float = 100.0           # ref: skip windows with range_x < 100
    image_width: int = 3840
    image_height: int = 1280
    vision_dim: int = 512
    max_polygon_points: int = 64
    max_length: int = 512                # text token budget (ref train.py:1071)
    train_ratio: float = 0.7
    val_ratio: float = 0.2
    test_ratio: float = 0.1
    split_seed: int = 42                 # ref split is unseeded per-rank; we fix it
    use_vision: bool = True
    use_text: bool = True
    # prompt style: "describe" (ref train.py:200-212) or "role" (ref
    # scripts/im_kim_train_GRN.py:227-234)
    prompt_style: str = "describe"
    # static text-length buckets (ascending): each batch's text arrays are
    # trimmed to the smallest bucket covering the batch's longest row, so
    # the LLM forward skips all-pad tail positions.  A handful of buckets
    # means a handful of compiled shapes (vs the reference's per-batch-max
    # dynamic padding = a new shape every batch).  () = always max_length.
    # Metric-neutral: pad positions are attention-masked and label-masked
    # (pinned by tests/test_data.py + the serve-path neutrality tests).
    # DEFAULT ON since r4: with the real HF tokenizer the reference's
    # context paragraphs sit well under the 512-token cap (ref
    # scripts/train.py:1071), and the interleaved A/B measured +30%
    # eval throughput @384 / +69% @256 (PARITY.md).  Disable with
    # --length-buckets none (or length_buckets=()).
    length_buckets: Tuple[int, ...] = (256, 384, 512)


@dataclass(frozen=True)
class LlamaConfig:
    """Minimal Llama-3.2-style decoder config (RMSNorm/RoPE/GQA/SwiGLU).

    Defaults mirror meta-llama/Llama-3.2-1B (ref scripts/train.py:1364 model
    key).  ``tiny()`` builds a test-size config.
    """
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_layers: int = 16
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 64
    rope_theta: float = 500000.0
    rope_scaling_factor: float = 32.0    # llama-3.2 long-context rope scaling
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    remat: bool = False   # rematerialize each layer (memory <-> FLOPs)
    # remat policy when remat=True: "full" recomputes everything in the
    # backward (minimum memory); "dots" saves matmul outputs and recomputes
    # only elementwise/norm ops (jax.checkpoint_policies.checkpoint_dots —
    # skips the expensive MXU recompute at ~hundreds of MB/layer of saved
    # activations; measured on the joint 1.31B step, see PARITY.md)
    remat_policy: str = "full"
    # chunked LM-loss: >0 computes the causal-LM CE in sequence chunks of
    # this size without materializing the (B, T, 128256) logits (identical
    # value/grads to the dense loss; see models/llama.py
    # causal_lm_loss_chunked).  0 = dense.
    loss_chunk: int = 0
    use_lora: bool = True
    lora_r: int = 8
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1
    # which projections get LoRA (PEFT CAUSAL_LM default = q_proj,v_proj)
    lora_targets: Tuple[str, ...] = ("q_proj", "v_proj")

    @staticmethod
    def tiny(vocab_size: int = 384) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            rope_scaling_factor=1.0)


@dataclass(frozen=True)
class QFormerConfig:
    """BLIP-2-style Q-Former (ref scripts/train.py:388-414)."""
    vision_dim: int = 512
    hidden_size: int = 768
    num_heads: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 4
    num_query_tokens: int = 16
    dropout: float = 0.1


@dataclass(frozen=True)
class LTSFConfig:
    """LTSF-NLinear + self-attention forecaster (ref scripts/train.py:659-842)."""
    d_model: int = 64
    individual: bool = True
    # every reference args dict sets ltsf_nhead=2 (e.g. scripts/train.py:
    # 1360, modify_scripts/test.py:1082) even though the class default is 1
    nhead: int = 2
    dropout: float = 0.1
    polygon_embed_dim: int = 64
    use_post_mlp: bool = True
    post_mlp_hidden_dim: int = 64
    cross_nhead: int = 2
    feature_size: int = 2


@dataclass(frozen=True)
class LaneEncoderConfig:
    """Lane polygon encoder (ref scripts/train.py:352-383)."""
    d_model: int = 64
    nhead: int = 4
    num_layers: int = 2
    max_points: int = 64
    dropout: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    llama: LlamaConfig = field(default_factory=LlamaConfig)
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    ltsf: LTSFConfig = field(default_factory=LTSFConfig)
    lane: LaneEncoderConfig = field(default_factory=LaneEncoderConfig)
    use_llm: bool = True       # False => no-LLM ablation (ref ablation_study.py)
    use_vision: bool = True    # False => dummy-text ablation (ref modify_train2.py)
    dtype: str = "float32"     # compute dtype; "bfloat16" for the fast path


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    epochs: int = 300
    lr: float = 5e-4
    weight_decay: float = 1e-4
    grad_clip: Optional[float] = 1.0
    # freeze regime, matching ref variants (SURVEY.md §2.6 T1-T4):
    #   "frozen_mllm"  — stage 2 canonical: MLLM (qformer+llama+lora) frozen
    #   "joint"        — everything trainable (im_kim_train_GRN.py)
    #   "lora_only"    — only LoRA params of the LLM + non-LLM trainable heads?
    #                    ref modify_train.py:522-528 trains only lora_* inside
    #                    the MLLM; forecaster params stay trainable.
    #   "full_freeze"  — LLM fully frozen incl. LoRA (modify.py:523-525)
    freeze_regime: str = "frozen_mllm"
    nan_guard: bool = True     # skip non-finite updates (ref modify_train.py:1188-1194)
    seed: int = 42
    # PRNG implementation for the training rng ("threefry2x32" default =
    # JAX's counter-based PRNG, bit-stable across backends/versions;
    # "rbg" = the TPU hardware RNG — equally random dropout masks drawn
    # from a different stream, measured -11% on the frozen-MLLM 1B train
    # step (171.6 -> 153.0 ms interleaved) because threefry mask
    # generation is VPU-heavy.  Same knob the parity-eval "optimized"
    # mode uses (PARITY.md "Parity-mode eval profile").
    rng_impl: str = "threefry2x32"
    eval_num_candidates: int = 10
    log_every: int = 50


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh. data axis = DP (ref DDP/NCCL, scripts/train.py:1044-1049);
    model axis = optional TP for the 1B Llama (absent in reference).
    ``fsdp`` additionally shards large params (and, since optimizer state
    mirrors param placement, the Adam moments) along the data axis —
    ZeRO-3-style, composing with TP on the other dim; XLA inserts the
    per-layer all-gathers/reduce-scatters from the shardings alone."""
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1
    fsdp: bool = False
    # GPipe-style pipeline parallelism over the Llama decoder depth
    # (parallel/pipeline.py; stage-1 LM fine-tune path).  >1 splits the
    # layer stack into that many stages on a ("data", "pipe") mesh;
    # ``microbatches`` is the GPipe microbatch count (clamped to the
    # largest value that divides the per-data-shard batch).
    pipeline_parallel: int = 1
    microbatches: int = 4


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "train_18_30"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _exp(name, seq_len, out_len, **train_kw):
    return ExperimentConfig(
        name=name,
        data=DataConfig(seq_len=seq_len, out_len=out_len),
        train=TrainConfig(**train_kw) if train_kw else TrainConfig(),
    )


def _tiny_model(vocab_size: int = 384, **model_kw) -> ModelConfig:
    return ModelConfig(llama=LlamaConfig.tiny(vocab_size), **model_kw)


# Named presets reproducing the reference script matrix (SURVEY.md §2.7).
PRESETS = {
    # scripts/train.py — canonical stage-2 trainer (18->30, frozen MLLM)
    "train_18_30": _exp("train_18_30", 18, 30),
    # scripts/test.py — K=10 MC-dropout eval at 18->18
    "test_18_18": _exp("test_18_18", 18, 18, eval_num_candidates=10),
    # scripts/test_10.py — 6->12
    "test_6_12": _exp("test_6_12", 6, 12, eval_num_candidates=10),
    # scripts/seed_fix_train.py — joint training, 24->24, K=6; the script
    # ships with epochs=3 (seed_fix_train.py args) — override with --epochs
    "seed_fix_24_24": _exp("seed_fix_24_24", 24, 24,
                           freeze_regime="joint", eval_num_candidates=6,
                           epochs=3),
    # scripts/im_kim_train_GRN.py — joint end-to-end, 24->24 (QFormer 2+2)
    "joint_24_24": dataclasses.replace(
        _exp("joint_24_24", 24, 24, freeze_regime="joint"),
        model=ModelConfig(qformer=QFormerConfig(num_encoder_layers=2,
                                                num_decoder_layers=2))),
    # scripts/ablation_study.py — no-LLM ablation, 6->30
    "ablation_no_llm": dataclasses.replace(
        _exp("ablation_no_llm", 6, 30),
        model=ModelConfig(use_llm=False)),
    # scripts/ablation_study_without_lora.py — no-LoRA, 6->30
    "ablation_no_lora": dataclasses.replace(
        _exp("ablation_no_lora", 6, 30),
        model=ModelConfig(llama=LlamaConfig(use_lora=False))),
    # modify_scripts/modify_train2.py / 3 — no-vision / dummy-text, 18->12, 18->6
    "ablation_no_vision_18_12": dataclasses.replace(
        _exp("ablation_no_vision_18_12", 18, 12),
        model=ModelConfig(use_vision=False)),
    "ablation_no_vision_18_6": dataclasses.replace(
        _exp("ablation_no_vision_18_6", 18, 6),
        model=ModelConfig(use_vision=False)),
    # modify_scripts/modify.py — full-freeze, 30->6 (bs8, lr 1e-5,
    # modify.py args dict)
    "full_freeze_30_6": _exp("full_freeze_30_6", 30, 6,
                             freeze_regime="full_freeze",
                             batch_size=8, lr=1e-5),
    # modify_scripts/modify_train.py — LoRA-only, 18->18, 500 epochs
    # (bs8, lr 1e-5, modify_train.py args dict)
    "lora_only_18_18": _exp("lora_only_18_18", 18, 18,
                            freeze_regime="lora_only", epochs=500,
                            batch_size=8, lr=1e-5),
    # scripts/modify_im_kim_train.py — im_kim joint variant with lr 1e-4
    # and dropout 0.05 throughout (LoRA + forecaster); grad clip and
    # norm_stat sanitation are framework defaults here
    "im_kim_modified_24_24": dataclasses.replace(
        _exp("im_kim_modified_24_24", 24, 24, freeze_regime="joint",
             lr=1e-4),
        model=ModelConfig(
            llama=LlamaConfig(lora_dropout=0.05),
            qformer=QFormerConfig(num_encoder_layers=2,
                                  num_decoder_layers=2),
            ltsf=LTSFConfig(dropout=0.05))),
    # modify_scripts/test.py — debug-instrumented joint trainer, 18->30,
    # bs8, lr 1e-5
    "joint_debug_18_30": _exp("joint_debug_18_30", 18, 30,
                              freeze_regime="joint", batch_size=8,
                              lr=1e-5),
    # modify_scripts/ablation.py — clean MLLM-free pipeline, 18->18
    "mllm_free_18_18": dataclasses.replace(
        _exp("mllm_free_18_18", 18, 18),
        model=ModelConfig(use_llm=False)),
}


def get_preset(name: str) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
