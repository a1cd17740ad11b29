"""Stage-1 MLLM fine-tuning in the port against the JAX package: the
causal-LM losses (dense and chunked), ``MultiModalLLM.lm_loss``, three
stage-1 train steps in two regimes, and ``run_stage1`` on the CPU with its
artifact handed to ``run_stage2(mllm_ckpt=...)``.

The parity model is a tiny MultiModalLLM (Llama 2 layers of 64, 4/2 heads
of 16, vocabulary 384; Q-Former 1 + 1 layers of 32, 4 query tokens); Flax
initialises it and ``convert.load_flax_params`` carries the weights across.
Both sides take the same numpy batch with every dropout at 0, since torch
cannot reproduce JAX's masks.  Tolerances: losses and hidden gradients
within 1e-5; after three AdamW steps, losses within rtol 1e-4 and the
trainable parameters within atol 2e-6 (0.4% of one step at lr 5e-4),
except where Adam turns rounding into a step, the rule of
``tests/test_torch_train.py``: an element whose first gradient is below
1e-4, or below 1e-3 of its tensor's largest, and the Q-Former's attention
key biases (their gradient is zero in exact arithmetic, a shift common to
all keys) step on noise near Adam's eps and may move by up to ~lr
differently: atol 2 * lr per step there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu.models import llama as jax_llama
from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
from tsue_tpu.train import stage1 as jax_stage1
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import _convert_leaf, _flatten, load_flax_params
from tsue_tpu_torch.models import llama
from tsue_tpu_torch.models.fusion import IGNORE_LABEL, MultiModalLLM
from tsue_tpu_torch.train import stage1
from tsue_tpu_torch.train.trainer import TrainState
from tsue_tpu_torch.utils.random import step_generator

B, L, TV, V = 4, 24, 6, 384
STEPS = 3
LR = 5e-4


def _llama_cfg(c, dropout=0.0):
    return c.LlamaConfig(vocab_size=V, hidden_size=64, intermediate_size=128,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, rope_scaling_factor=1.0,
                         lora_dropout=dropout)


def _qformer_cfg(c, dropout=0.0):
    return c.QFormerConfig(hidden_size=32, num_heads=2, num_encoder_layers=1,
                           num_decoder_layers=1, num_query_tokens=4,
                           dropout=dropout)


def _exp_cfg(c, dropout=0.0):
    """A stage-1/stage-2 configuration of the same tiny MLLM whose 600-byte
    text keeps the answers of the byte tokenizer's ~430-byte prompts."""
    return c.ExperimentConfig(
        name="torch_stage1",
        data=c.DataConfig(seq_len=6, out_len=6, max_length=600,
                          length_buckets=()),
        model=c.ModelConfig(
            llama=_llama_cfg(c, dropout),
            qformer=_qformer_cfg(c, dropout),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1,
                                     dropout=dropout),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16,
                              dropout=dropout)),
        train=c.TrainConfig(batch_size=4, lr=LR, freeze_regime="frozen_mllm"))


def _batch(seed=0):
    """Random ids; rows of 24, 20, 17 and 24 valid tokens; labels -100 over
    the first 8 (the prompt) and the padding."""
    rng = np.random.default_rng(seed)
    lens = np.array([L, 20, 17, L])
    pos = np.arange(L)[None]
    mask = (pos < lens[:, None]).astype(np.int32)
    ids = (rng.integers(0, V, (B, L)) * mask).astype(np.int32)
    labels = np.where((pos >= 8) & (mask > 0), ids, IGNORE_LABEL)
    return dict(vision=rng.standard_normal((B, TV, 512)).astype(np.float32),
                input_ids=ids, attention_mask=mask,
                labels=labels.astype(np.int32))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    jmllm = JaxMLLM(llama=_llama_cfg(jax_config),
                    qformer=_qformer_cfg(jax_config))
    b = _jb(_batch())
    params = jax.device_get(jax.jit(lambda b: jmllm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        b["vision"], b["input_ids"], b["attention_mask"]))(b)["params"])
    yield dict(jmllm=jmllm, params=params)
    torch.set_num_threads(prev)


def _port_mllm(params):
    m = MultiModalLLM(_llama_cfg(port_config), _qformer_cfg(port_config))
    return load_flax_params(m, params)


def _port_named(model, tree):
    """{port parameter name: (array in the port's layout, Flax path)}."""
    modules = dict(model.named_modules())
    out = {}
    for path, value in _flatten(tree).items():
        mod = ".".join(path[:-1])
        name, arr = _convert_leaf(modules[mod], path[-1], value, "/".join(path))
        out[f"{mod}.{name}" if mod else name] = (np.asarray(arr), path)
    return out


# --------------------------------------------------------------------------
# the losses
# --------------------------------------------------------------------------

def _loss_inputs(T=13, D=16, seed=1):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((3, T, D)).astype(np.float32)
    w = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (3, T)).astype(np.int32)
    labels[:, :4] = IGNORE_LABEL
    labels[1, 7:] = IGNORE_LABEL
    labels[2] = IGNORE_LABEL          # a row with nothing to predict
    return hidden, w, labels


def test_causal_lm_loss_matches_jax():
    hidden, w, labels = _loss_inputs()
    logits = hidden @ w.T
    ref = jax_llama.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    out = llama.causal_lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5, atol=1e-5)
    none = np.full_like(labels, IGNORE_LABEL)
    assert float(llama.causal_lm_loss(torch.from_numpy(logits),
                                      torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("chunk", [5, 12, 64])
def test_chunked_loss_matches_jax_value_and_hidden_gradient(chunk):
    """T - 1 = 12 shifted positions: a chunk of 5 pads 3 positions with
    -100, 12 is one exact chunk, 64 a single padded one.  The value and
    the hidden and head-weight gradients against the JAX chunked loss and
    the port's dense loss, within 1e-5."""
    hidden, w, labels = _loss_inputs()

    def jax_loss(h, w_):
        return jax_llama.causal_lm_loss_chunked(
            h, jnp.asarray(labels), lambda x: x @ w_.T, chunk)
    ref, (rh, rw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(w))
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = llama.causal_lm_loss_chunked(th, torch.from_numpy(labels),
                                       lambda h, w_: h @ w_.t(), chunk, tw)
    out.backward()
    out = out.detach()
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(rh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rw), atol=1e-5,
                               rtol=1e-5)
    dh = torch.from_numpy(hidden).requires_grad_()
    dense = llama.causal_lm_loss(dh @ torch.from_numpy(w).t(),
                                 torch.from_numpy(labels))
    dense.backward()
    np.testing.assert_allclose(float(out), float(dense.detach()), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), dh.grad.numpy(), atol=1e-6)


@pytest.mark.parametrize("loss_chunk", [0, 7])
def test_lm_loss_matches_jax(setup, loss_chunk):
    """``MultiModalLLM.lm_loss`` (deterministic) against the JAX method on
    the same weights and batch, dense and chunked; the image span's -100s
    keep the 4 image tokens out of the loss."""
    batch = _batch(2)
    jm = setup["jmllm"]
    if loss_chunk:
        jm = JaxMLLM(llama=dataclasses.replace(_llama_cfg(jax_config),
                                               loss_chunk=loss_chunk),
                     qformer=_qformer_cfg(jax_config))
    jb = _jb(batch)
    ref = jm.apply({"params": setup["params"]}, jb["vision"],
                   jb["input_ids"], jb["attention_mask"], jb["labels"], True,
                   method=jm.lm_loss)
    port = MultiModalLLM(dataclasses.replace(_llama_cfg(port_config),
                                             loss_chunk=loss_chunk),
                         _qformer_cfg(port_config))
    load_flax_params(port, setup["params"])
    tb = _tb(batch)
    out = port.lm_loss(tb["vision"], tb["input_ids"], tb["attention_mask"],
                       tb["labels"])
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        port.lm_loss(tb["vision"], tb["input_ids"], tb["attention_mask"],
                     tb["labels"], deterministic=False)


# --------------------------------------------------------------------------
# three train steps
# --------------------------------------------------------------------------

def test_freeze_labels_equal_jax(setup):
    port = _port_mllm(setup["params"])
    named = _port_named(port, setup["params"])
    assert sorted(named) == sorted(n for n, _ in port.named_parameters())
    for name, (_, path) in named.items():
        for regime in ("lora_only", "joint"):
            assert stage1.stage1_freeze_label(tuple(name.split(".")), regime) \
                == jax_stage1.stage1_freeze_label(path, regime), (name,
                                                                  regime)


def _jax_run(setup, regime, batches):
    cfg = _exp_cfg(jax_config)
    label_fn = lambda p: jax_stage1.stage1_freeze_label(p, regime)  # noqa
    tx = jax_stage1.make_stage1_optimizer(cfg, setup["params"], label_fn)
    step = jax.jit(jax_stage1.make_stage1_train_step(setup["jmllm"], tx))
    params, opt_state = setup["params"], tx.init(setup["params"])
    losses = []
    for i, b in enumerate(batches):
        params, opt_state, m = step(params, opt_state, _jb(b),
                                    jax.random.key(i))
        losses.append(float(m["lm_loss"]))
    return losses, jax.device_get(params)


@pytest.mark.parametrize("regime", ["lora_only", "joint"])
def test_three_stage1_steps_match_jax(setup, regime):
    batches = [_batch(10 + i) for i in range(STEPS)]
    cfg = _exp_cfg(port_config)
    model = _port_mllm(setup["params"])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState(model, stage1.make_stage1_optimizer(cfg, model, regime),
                       cfg.train.seed)
    b0 = _tb(batches[0])
    model.lm_loss(b0["vision"], b0["input_ids"], b0["attention_mask"],
                  b0["labels"]).backward()
    grads = {n: p.grad.abs() for n, p in model.named_parameters()
             if p.grad is not None}
    state.optimizer.zero_grad()
    step = stage1.make_stage1_train_step()
    losses = [float(step(state, _tb(b), step_generator(0, i))["lm_loss"])
              for i, b in enumerate(batches)]
    assert state.step == STEPS
    assert state.optimizer.grad_clip == 1.0
    jax_losses, jax_params = _jax_run(setup, regime, batches)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    ref = _port_named(model, jax_params)
    trained = 0
    for name, p in model.named_parameters():
        train = stage1.stage1_freeze_label(tuple(name.split(".")),
                                           regime) == "train"
        assert p.requires_grad == train, name
        if not train:
            assert torch.equal(p.detach(), start[name]), name
        trained += train and not torch.equal(p.detach(), start[name])
        out, r = p.detach().numpy(), ref[name][0]
        if not train:
            np.testing.assert_array_equal(out, r, err_msg=name)
            continue
        g = grads[name].numpy()
        small = (g < 1e-4) | (g < 1e-3 * g.max()) | name.endswith(".k.bias")
        np.testing.assert_allclose(out[~small], r[~small], rtol=0, atol=2e-6,
                                   err_msg=name)
        np.testing.assert_allclose(out[small], r[small], rtol=0,
                                   atol=2 * LR * STEPS, err_msg=name)
    assert trained > 0
    ev = stage1.make_stage1_eval_step()(state, _tb(batches[0]))["lm_loss"]
    assert np.isfinite(float(ev)) and not ev.requires_grad


def test_stage1_clip_is_never_off():
    """``grad_clip=None`` still clips at 1.0 in stage 1, as the JAX
    package's ``cfg.train.grad_clip or 1.0``."""
    cfg = _exp_cfg(port_config)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, grad_clip=None))
    model = MultiModalLLM(_llama_cfg(port_config), _qformer_cfg(port_config))
    assert stage1.make_stage1_optimizer(cfg, model).grad_clip == 1.0


# --------------------------------------------------------------------------
# generation from the prompt span
# --------------------------------------------------------------------------

def test_prompt_only_and_greedy_texts_match_jax(setup):
    """``prompt_only`` keeps the prompt span (labels == -100) of dataset
    rows, and greedy ``generate_texts`` from it gives the JAX package's
    strings on the same weights."""
    from tsue_tpu.eval import generation as jax_gen
    from tsue_tpu.ops.sampling import SamplingConfig as JaxSampling
    from tsue_tpu_torch.data import ByteTokenizer
    from tsue_tpu_torch.eval import generation
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    batch = _batch(3)
    ids, mask = generation.prompt_only(batch)
    jids, jmask = jax_gen.prompt_only(batch)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert (mask.sum(1) == 8).all()
    tok = ByteTokenizer()
    ref = jax_gen.generate_texts(
        setup["jmllm"], {"params": setup["params"]}, tok,
        jnp.asarray(batch["vision"]), ids, mask, jax.random.key(0),
        max_new_tokens=6, cfg=JaxSampling(do_sample=False))
    out = generation.generate_texts(
        _port_mllm(setup["params"]), tok, torch.from_numpy(batch["vision"]),
        ids, mask, None, max_new_tokens=6,
        cfg=SamplingConfig(do_sample=False))
    assert out == ref and len(out) == B


# --------------------------------------------------------------------------
# run_stage1 -> run_stage2(mllm_ckpt=...) on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage1_run(tmp_path_factory):
    from tsue_tpu_torch.runner import run_stage1
    out = tmp_path_factory.mktemp("stage1")
    cfg = _exp_cfg(port_config, dropout=0.1)
    metrics = run_stage1(cfg, out_dir=str(out / "runs"), epochs=1,
                         export_path=str(out / "mllm"), synthetic_tracks=6,
                         generation_dump="generated.txt", device="cpu")
    return cfg, out, metrics


def test_run_stage1_trains_exports_and_dumps(stage1_run):
    from tsue_tpu_torch.data import ByteTokenizer
    cfg, out, metrics = stage1_run
    assert set(metrics) == {"final_lm_loss", "generated"}
    assert np.isfinite(metrics["final_lm_loss"])
    assert metrics["final_lm_loss"] > 0         # answers survive truncation
    assert metrics["generated"] > 0
    dump = (out / "runs" / f"stage1_{cfg.name}" / "generated.txt").read_text()
    assert dump.count("GENERATED:") == metrics["generated"]
    assert "REFERENCE:" in dump
    state = torch.load(out / "mllm" / "state.pt", weights_only=True)
    m = MultiModalLLM(dataclasses.replace(
        _llama_cfg(port_config), vocab_size=ByteTokenizer().vocab_size),
        _qformer_cfg(port_config))
    assert sorted(state) == sorted(m.state_dict())


def test_run_stage2_loads_the_stage1_artifact(stage1_run, tmp_path):
    from tsue_tpu_torch.data import ByteTokenizer
    from tsue_tpu_torch.runner import build_model_and_params, run_stage2
    cfg, out, _ = stage1_run
    art = str(out / "mllm")
    state = torch.load(out / "mllm" / "state.pt", weights_only=True)
    model = build_model_and_params(cfg, ByteTokenizer(), "cpu", mllm_ckpt=art)
    got = model.mllm.state_dict()
    assert sorted(got) == sorted(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    fresh = build_model_and_params(cfg, ByteTokenizer(), "cpu")
    assert not torch.equal(fresh.mllm.qformer.query_tokens,
                           state["qformer.query_tokens"])
    metrics = run_stage2(cfg, out_dir=str(tmp_path), mllm_ckpt=art, epochs=1,
                         synthetic_tracks=6, device="cpu")
    assert set(metrics) == {"test_ade", "test_fde"}
    assert all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("fault", ["shape", "missing"])
def test_import_mllm_is_strict(stage1_run, tmp_path, fault):
    from tsue_tpu_torch.data import ByteTokenizer
    from tsue_tpu_torch.runner import build_model_and_params
    from tsue_tpu_torch.train.checkpoint import STATE_FILE
    cfg, out, _ = stage1_run
    state = torch.load(out / "mllm" / STATE_FILE, weights_only=True)
    if fault == "shape":
        state["text_modality_embedding"] = torch.zeros(1, 1, 32)
        err = ValueError
    else:
        del state["qformer.query_tokens"]
        err = KeyError
    (tmp_path / "bad").mkdir()
    torch.save(state, tmp_path / "bad" / STATE_FILE)
    with pytest.raises(err):
        build_model_and_params(cfg, ByteTokenizer(), "cpu",
                               mllm_ckpt=str(tmp_path / "bad"))
