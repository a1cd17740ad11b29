"""Per-layer remat in the port (``LlamaConfig.remat``): a rematerialised
train step equals the plain one bit for bit on the CPU, LoRA dropout
included, under each of the three policies; the deterministic remat loss
against the JAX package's ``LlamaForCausalLM(remat=True)``; the policy
names; remat through ``run_stage2``, ``run_stage1`` and the CLI; stage 1
of a bf16 configuration, which trains in fp32 and is held to the same
fp32 run as the remat run.

The step's model is the train-parity model of ``tests/test_torch_train.py``
(a 2-layer, 128-wide Llama with LoRA on q and v) with every dropout at 0.1
and its fused switch on, initialised once from a seed; each step starts
from those weights and draws its dropout from ``step_generator(42, 0)``.
Without the generator's replay the recompute draws other LoRA masks and
the gradients differ (checked once, below).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.data import BatchIterator, build_windows
from tsue_tpu_torch.data import make_synthetic_tracks
from tsue_tpu_torch.data.tokenizer import ByteTokenizer
from tsue_tpu_torch.models import llama as L
from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
from tsue_tpu_torch.ops.fused import fused_scope
from tsue_tpu_torch.train import trainer

from test_torch_train import _cfg

POLICIES = ("full", "dots", "dots_no_batch")


def _remat(cfg, policy):
    """``cfg`` with the Llama rematerialised under ``policy`` (None: no
    remat)."""
    llama = dataclasses.replace(cfg.model.llama, remat=policy is not None,
                                remat_policy=policy or "full")
    return cfg.replace(model=dataclasses.replace(cfg.model, llama=llama))


@pytest.fixture(scope="module")
def small():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = _cfg(port_config, dropout=0.1)
    ds = build_windows(make_synthetic_tracks(num_tracks=3, track_len=300,
                                             seed=1), cfg.data,
                       ByteTokenizer())
    batch = next(iter(BatchIterator(ds, 4, shuffle=True, seed=42)))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in dict(batch, polygon=batch["polygon"] / 1000.0)
             .items()}
    model = TrajectoryModel(cfg.model, 6, 6)
    init_params(model, torch.Generator().manual_seed(0))
    yield dict(cfg=cfg, batch=batch,
               start={k: v.clone() for k, v in model.state_dict().items()})
    torch.set_num_threads(prev)


def _step(small, regime, policy):
    """One train step (``make_train_step``) from the fixture's weights:
    the loss, every gradient, the updated parameters."""
    cfg = _remat(small["cfg"], policy)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                freeze_regime=regime))
    model = TrajectoryModel(cfg.model, 6, 6)
    model.load_state_dict(small["start"])
    with fused_scope("on"):
        state = trainer.TrainState(model, trainer.make_optimizer(cfg, model),
                                   cfg.train.seed)
        loss = trainer.make_train_step(cfg)(state, small["batch"])["loss"]
    return (loss, {n: p.grad for n, p in model.named_parameters()
                   if p.grad is not None},
            {n: p.detach() for n, p in model.named_parameters()})


@pytest.fixture(scope="module")
def plain_steps(small):
    return functools.lru_cache(None)(
        lambda regime: _step(small, regime, None))


@pytest.mark.parametrize("regime", ["lora_only", "joint"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_equals_the_plain_step(small, plain_steps, policy,
                                          regime):
    """Loss, every gradient and every updated parameter bit for bit, with
    LoRA (and every other) dropout at 0.1."""
    loss, grads, params = _step(small, regime, policy)
    ref_loss, ref_grads, ref_params = plain_steps(regime)
    assert torch.equal(loss, ref_loss)
    assert sorted(grads) == sorted(ref_grads)
    assert any("lora_a" in n for n in grads)
    for n, g in grads.items():
        assert torch.equal(g, ref_grads[n]), n
    for n, p in params.items():
        assert torch.equal(p, ref_params[n]), n


def test_recompute_without_the_replay_draws_other_masks(small, plain_steps,
                                                        monkeypatch):
    """The check above has teeth: a recompute that draws on from the
    generator (what ``torch.utils.checkpoint`` alone would do) gives other
    LoRA gradients."""
    monkeypatch.setattr(L, "_replay", lambda g: (lambda: g))
    loss, grads, _ = _step(small, "joint", "full")
    ref_loss, ref_grads, _ = plain_steps("joint")
    assert torch.equal(loss, ref_loss)       # the forward is the same
    assert not all(torch.equal(g, ref_grads[n]) for n, g in grads.items())


def test_remat_only_where_autograd_records(small, monkeypatch):
    """Checkpointed: a training forward (one call per layer).  Not: a
    forward under no_grad, and decode (a KV cache)."""
    calls = []
    real = L.checkpoint
    monkeypatch.setattr(L, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = _remat(small["cfg"], "dots")
    model = TrajectoryModel(cfg.model, 6, 6)
    model.load_state_dict(small["start"])
    b = small["batch"]
    model(b, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert len(calls) == cfg.model.llama.num_layers
    with torch.no_grad():
        model(b)
    mllm = model.mllm
    caches, _, plen, fmask = mllm.prefill(b["vision"][:1],
                                          b["input_ids"][:1],
                                          b["attention_mask"][:1], 40)
    mllm.decode_step(torch.zeros(1, dtype=torch.long), 0, plen, caches,
                     fmask, 40)
    assert len(calls) == cfg.model.llama.num_layers


def test_remat_loss_matches_jax_llama():
    """The deterministic causal-LM loss and its gradients of a
    rematerialised ``LlamaForCausalLM`` (2 layers, 128 wide, LoRA on q and
    v) against the JAX package's with ``remat=True``: the loss within 1e-5
    relative, every gradient within 1e-4 of its tensor's largest (fp32,
    sums in other orders)."""
    import jax
    import jax.numpy as jnp
    from tsue_tpu import config as jax_config
    from tsue_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from tsue_tpu_torch.convert import load_flax_params
    from test_torch_train import _port_named
    jcfg = dataclasses.replace(_cfg(jax_config).model.llama, remat=True,
                               remat_policy="dots")
    pcfg = dataclasses.replace(_cfg(port_config).model.llama, remat=True,
                               remat_policy="dots")
    rng = np.random.default_rng(3)
    B, T, D = 2, 24, pcfg.hidden_size
    emb = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 18:] = 0
    labels = rng.integers(0, pcfg.vocab_size, (B, T)).astype(np.int32)
    labels[:, :6] = -100
    jmodel = JaxLlama(jcfg)
    # token ids at init create the embedding table, which the tied head uses
    params = jax.jit(lambda m: jmodel.init(
        jax.random.key(0), attention_mask=m, input_ids=jnp.zeros(
            (B, T), jnp.int32), labels=jnp.asarray(labels)))(
        jnp.asarray(mask))["params"]

    def loss_fn(p):
        return jmodel.apply({"params": p}, jnp.asarray(emb), jnp.asarray(mask),
                            jnp.asarray(labels))["loss"]
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = load_flax_params(L.LlamaForCausalLM(pcfg),
                             jax.device_get(params))
    loss = model(torch.from_numpy(emb), torch.from_numpy(mask),
                 labels=torch.from_numpy(labels))["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref_g = _port_named(model, jax.device_get(ref_grads))
    for name, p in model.named_parameters():
        r = ref_g[name][0]
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-7,
                                   err_msg=name)


def test_unknown_remat_policy_raises_the_jax_error():
    from tsue_tpu.models import llama as jax_llama
    with pytest.raises(ValueError) as jax_err:
        jax_llama._remat_policy("bogus")
    cfg = dataclasses.replace(port_config.LlamaConfig.tiny(), remat=True,
                              remat_policy="bogus")
    with pytest.raises(ValueError) as err:
        L.LlamaForCausalLM(cfg)
    assert str(err.value) == str(jax_err.value)
    # without remat the name is not read, as in the JAX package
    L.LlamaForCausalLM(dataclasses.replace(cfg, remat=False))


def _joint_flow():
    from test_torch_checkpoint import _flow_cfg
    cfg = _flow_cfg()
    return cfg.replace(train=dataclasses.replace(cfg.train,
                                                 freeze_regime="joint"))


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """One epoch of the tiny joint configuration without remat: its test
    metrics and best artifact."""
    from test_torch_checkpoint import RUN
    from tsue_tpu_torch.runner import run_stage2
    from tsue_tpu_torch.train.checkpoint import _read
    cfg = _joint_flow()
    out = tmp_path_factory.mktemp("plain")
    metrics = run_stage2(cfg, out_dir=str(out), epochs=1, **RUN)
    return metrics, _read(str(out / cfg.name / "ckpt" / "best"))


@pytest.mark.parametrize("policy", POLICIES)
def test_run_stage2_with_remat_equals_without(policy, plain_run, tmp_path):
    """``run_stage2`` trains a rematerialised Llama: one epoch of the tiny
    joint configuration, its test metrics and best artifact equal to the
    run without remat."""
    from test_torch_checkpoint import RUN
    from tsue_tpu_torch.runner import run_stage2
    from tsue_tpu_torch.train.checkpoint import _read
    cfg = _remat(_joint_flow(), policy)
    metrics = run_stage2(cfg, out_dir=str(tmp_path), epochs=1, **RUN)
    assert metrics == plain_run[0]
    best = _read(str(tmp_path / cfg.name / "ckpt" / "best"))
    assert all(torch.equal(best[k], plain_run[1][k]) for k in best)


def _stage1_cfg(dtype="float32"):
    """The tiny stage-1 configuration with LoRA dropout 0.1, windows every
    30 frames (a fifth of the steps)."""
    from test_torch_stage1 import _exp_cfg
    cfg = _exp_cfg(port_config, dropout=0.1)
    return cfg.replace(data=dataclasses.replace(cfg.data, stride=30),
                       model=dataclasses.replace(cfg.model, dtype=dtype))


def _stage1(cfg, out):
    """``run_stage1`` for one epoch: (its LM losses, the exported MLLM)."""
    from tsue_tpu_torch.runner import run_stage1
    from tsue_tpu_torch.train.checkpoint import _read
    losses = run_stage1(cfg, out_dir=str(out / "run"), epochs=1,
                        export_path=str(out / "mllm"), synthetic_tracks=5,
                        device="cpu")
    return losses, _read(str(out / "mllm"))


@pytest.fixture(scope="module")
def stage1_plain(tmp_path_factory):
    """The fp32 stage-1 run without remat, which the remat and bf16 runs
    below are held to."""
    return _stage1(_stage1_cfg(), tmp_path_factory.mktemp("stage1"))


def test_run_stage1_with_remat_equals_without(stage1_plain, tmp_path):
    """``run_stage1`` (LoRA dropout 0.1) with remat: the LM losses and the
    exported MLLM equal the run without."""
    losses, mllm = _stage1(_remat(_stage1_cfg(), "full"), tmp_path)
    assert losses == stage1_plain[0]
    assert all(torch.equal(mllm[k], stage1_plain[1][k]) for k in mllm)


def test_stage1_of_a_bf16_config_is_its_fp32_run(stage1_plain, tmp_path):
    """``run_stage1`` ignores ``ModelConfig.dtype``, as the JAX package's
    does: a bf16 configuration gives the fp32 run's losses and artifact."""
    losses, mllm = _stage1(_stage1_cfg("bfloat16"), tmp_path)
    assert {v.dtype for v in mllm.values()} == {torch.float32}
    assert losses == stage1_plain[0]
    assert all(torch.equal(mllm[k], stage1_plain[1][k]) for k in mllm)


def test_cli_train_takes_remat(monkeypatch):
    """``--remat`` reaches ``run_stage2`` as a rematerialised Llama under
    the "full" policy.  The CLI run that trains with remat is
    ``test_torch_viz.py``'s (``--remat --remat-policy dots``)."""
    from tsue_tpu_torch import runner
    from tsue_tpu_torch.cli import train
    seen = []
    monkeypatch.setattr(runner, "run_stage2", lambda cfg, *a, **k:
                        seen.append(cfg) or {"test_ade": 0.0})
    train.main(["--tiny", "--device", "cpu", "--preset", "test_18_18",
                "--epochs", "1", "--synthetic-tracks", "5", "--batch-size",
                "4", "--out-dir", "unused", "--remat"])
    llama = seen[0].model.llama
    assert llama.remat and llama.remat_policy == "full"
