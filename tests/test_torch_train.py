"""Stage-2 training in the port against the JAX package: freeze labels, the
optimizer's trajectory, three train steps in three regimes, and
``run_stage2`` on the CPU.

The train-parity model is a tiny TrajectoryModel whose Llama (2 layers,
128 wide, 4/2 heads of 32, intermediate 256) reaches the fused kernels:
K % 128 == 0 and B * T = 4 * (4 image + 32 text tokens) = 144 >= 128 rows.
Both packages run with the fused switch on (the JAX kernels in interpret
mode, the port's Functions around their plain versions) and every dropout
at 0, since torch cannot reproduce JAX's masks.  Flax initialises the
weights and ``convert.load_flax_params`` carries them across; both take the
same ``BatchIterator`` batches, with the lane polygons in kilopixels: at
random init, raw pixel polygons saturate the lane encoder's attention,
whose softmax between nearly tied keys (logits ~1e6) is then set by fp32
rounding, and its gradients differ by up to 100% between any two orders of
summation.  In kilopixels every gradient agrees within ~3e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
from tsue_tpu.ops.fused import fused_scope as jax_fused_scope
from tsue_tpu.train import trainer as jax_trainer
from tsue_tpu.train.losses import denorm_mse_loss as jax_loss
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import _convert_leaf, _flatten, load_flax_params
from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                 make_synthetic_tracks)
from tsue_tpu_torch.data.tokenizer import ByteTokenizer
from tsue_tpu_torch.models.tsue import TrajectoryModel
from tsue_tpu_torch.ops.fused import fused_scope
from tsue_tpu_torch.train import trainer
from tsue_tpu_torch.train.losses import denorm_mse_loss
from tsue_tpu_torch.utils.random import step_generator

REGIMES = ("frozen_mllm", "lora_only", "joint", "full_freeze")
STEPS = 3
LR = 5e-4


def _cfg(c, regime="joint", dropout=0.0):
    """The train-parity configuration in the config classes of ``c``."""
    return c.ExperimentConfig(
        name="torch_train",
        data=c.DataConfig(seq_len=6, out_len=6, max_length=32),
        model=c.ModelConfig(
            llama=c.LlamaConfig(
                vocab_size=ByteTokenizer().vocab_size, hidden_size=128,
                intermediate_size=256, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=32, rope_scaling_factor=1.0,
                lora_dropout=dropout),
            qformer=c.QFormerConfig(hidden_size=32, num_heads=2,
                                    num_encoder_layers=1,
                                    num_decoder_layers=1,
                                    num_query_tokens=4, dropout=dropout),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1,
                                     dropout=dropout),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16,
                              dropout=dropout)),
        train=c.TrainConfig(batch_size=4, freeze_regime=regime, lr=LR))


def _port_named(model, tree):
    """{port parameter name: array in the port's layout} for a Flax tree
    (parameters, or gradients, which map the same way)."""
    modules = dict(model.named_modules())
    out = {}
    for path, value in _flatten(tree).items():
        mod = ".".join(path[:-1])
        name, arr = _convert_leaf(modules[mod], path[-1], value, "/".join(path))
        out[f"{mod}.{name}"] = (np.asarray(arr), path)
    return out


@pytest.fixture(scope="module")
def setup():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = _cfg(port_config)
    ds = build_windows(make_synthetic_tracks(num_tracks=3, track_len=300,
                                             seed=1), cfg.data, ByteTokenizer())
    it = BatchIterator(ds, 4, shuffle=True, seed=42)
    batches = [dict(b, polygon=b["polygon"] / 1000.0)
               for _, b in zip(range(STEPS), it)]
    jcfg = _cfg(jax_config)
    jmodel = JaxTrajectoryModel(jcfg.model, 6, 6)
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    params = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
        False))(jb0)["params"])
    yield dict(batches=batches, jmodel=jmodel, params=params)
    torch.set_num_threads(prev)


def _port_model(params):
    model = TrajectoryModel(_cfg(port_config).model, 6, 6)
    return load_flax_params(model, params)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("regime", REGIMES)
def test_freeze_labels_equal_jax(setup, regime):
    model = _port_model(setup["params"])
    named = _port_named(model, setup["params"])
    assert sorted(named) == sorted(n for n, _ in model.named_parameters())
    ours = trainer.param_labels(model, regime)
    for name, (_, path) in named.items():
        assert ours[name] == jax_trainer.freeze_label(path, regime), name
    assert {"train", "freeze"} >= set(ours.values())
    if regime != "joint":
        assert "freeze" in ours.values()


def _jax_grads(setup, batch):
    """The JAX loss and gradients of one batch (dropout 0, fused on)."""
    jmodel = setup["jmodel"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        pred = jmodel.apply({"params": p}, jb, False,
                            rngs={"dropout": jax.random.key(0)})
        return jax_loss(pred, jb["traj_out"], jb["norm_stat"], jb["valid"])
    with jax_fused_scope("on"):
        return jax.jit(jax.value_and_grad(loss_fn))(setup["params"])


@pytest.fixture(scope="module")
def jax_first_grads(setup):
    loss, grads = _jax_grads(setup, setup["batches"][0])
    return float(loss), jax.device_get(grads)


def _jax_run(setup, regime):
    """STEPS steps of the JAX package's own train step; the losses and the
    final parameters."""
    cfg = _cfg(jax_config, regime)
    jmodel = setup["jmodel"]

    def apply_fn(vs, b, det, rngs=None, **kw):
        return jmodel.apply(vs, b, det, rngs=rngs, **kw)
    with jax_fused_scope("on"):
        state = jax_trainer.TrainState.create(
            apply_fn, setup["params"],
            jax_trainer.make_optimizer(cfg, setup["params"]))
        step = jax.jit(jax_trainer.make_train_step(cfg))
        losses = []
        for b in setup["batches"]:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            jax.random.key(cfg.train.seed))
            losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params)


@pytest.mark.parametrize("regime", ["frozen_mllm", "lora_only", "joint"])
def test_three_train_steps_match_jax(setup, jax_first_grads, regime):
    """First-step trainable gradients within rtol 1e-4, atol 1e-4 of the
    tensor's largest gradient plus 1e-4: the loss is in squared pixels
    (~5e3), so gradients span decades, and the attention key biases'
    gradients are zero in exact arithmetic (a shift common to all keys) and
    come out as ~1e-5 of rounding noise on both sides.  Per-step losses
    within rtol 1e-4; frozen parameters bit-identical to their start.

    Parameters after 3 steps: Adam normalises each element's step to about
    lr whatever the gradient's size, and the clipped gradients sit near
    its eps, where a step moves by up to lr / 4 times the gradient's
    relative error.  The packages' gradients differ by ~3e-6 of the
    tensor's largest, so an element whose first gradient is below 1e-3 of
    that, below 1e-4 (noise, or exactly 0 like LoRA A while B is 0), or a
    key bias's (noise, see above) may move by up to ~lr differently in the
    two packages: those get atol 2 * lr per step.  Every other element
    agrees within atol 2e-6 (0.4% of one step at lr 5e-4)."""
    cfg = _cfg(port_config, regime)
    model = _port_model(setup["params"])
    with fused_scope("on"):
        state = trainer.TrainState(model, trainer.make_optimizer(cfg, model),
                                   cfg.train.seed)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        labels = trainer.param_labels(model, regime)
        # the first step's gradients, as the train step computes them
        b0 = _tb(setup["batches"][0])
        pred = model(b0, deterministic=False,
                     stop_llm_grad=regime == "frozen_mllm",
                     generator=step_generator(42, 0))
        denorm_mse_loss(pred, b0["traj_out"], b0["norm_stat"],
                        b0["valid"]).backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        state.optimizer.zero_grad()
        step = trainer.make_train_step(cfg)
        losses = [float(step(state, _tb(b))["loss"])
                  for b in setup["batches"]]
    assert state.step == STEPS
    assert sorted(grads) == sorted(n for n, l in labels.items()
                                   if l == "train")
    ref_loss, ref_grads = jax_first_grads
    np.testing.assert_allclose(losses[0], ref_loss, rtol=1e-4)
    ref_g = _port_named(model, ref_grads)
    for name, g in grads.items():
        r = ref_g[name][0]
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max() + 1e-4,
                                   err_msg=name)

    jax_losses, jax_params = _jax_run(setup, regime)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    ref_p = _port_named(model, jax_params)
    for name, p in model.named_parameters():
        out = p.detach().numpy()
        if labels[name] == "freeze":
            assert torch.equal(p.detach(), start[name]), name
            np.testing.assert_array_equal(ref_p[name][0],
                                          start[name].numpy())
            continue
        r, g = ref_p[name][0], np.abs(ref_g[name][0])
        small = (g < 1e-4) | (g < 1e-3 * g.max()) | name.endswith(".k.bias")
        np.testing.assert_allclose(out[~small], r[~small], rtol=0,
                                   atol=2e-6, err_msg=name)
        np.testing.assert_allclose(out[small], r[small], rtol=0,
                                   atol=2 * LR * STEPS, err_msg=name)


# --------------------------------------------------------------------------
# the optimizer against the optax chain
# --------------------------------------------------------------------------

OPT_SPEC = {
    "mllm.llama.layer_0.q_proj.kernel": (8, 8),
    "mllm.llama.layer_0.q_proj.lora_a": (8, 4),
    "mllm.qformer.dense.kernel": (6, 6),
    "ltsf.dense.kernel": (8, 6),
    "ltsf.dense.bias": (6,),
    "lane_encoder.conv.kernel": (3, 4, 4),
}


def _opt_module(arrays):
    """An nn.Module tree whose parameter names are the keys of ``arrays``."""
    root = torch.nn.Module()
    for name, arr in arrays.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if part not in mod._modules:
                mod.add_module(part, torch.nn.Module())
            mod = mod._modules[part]
        mod.register_parameter(leaf, torch.nn.Parameter(torch.tensor(arr)))
    return root


def _tree(flat):
    out = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _grad_seq(steps, big_step=None, nan_steps=()):
    rng = np.random.default_rng(7)
    seq = []
    for k in range(steps):
        g = {n: rng.normal(size=s).astype(np.float32)
             for n, s in OPT_SPEC.items()}
        if k == big_step:
            g = {n: v * 50.0 for n, v in g.items()}     # norm >> 1: clipped
        if k in nan_steps:
            g["ltsf.dense.bias"] = np.full((6,), np.nan, np.float32)
        seq.append(g)
    return seq


def _run_both(regime, seq):
    rng = np.random.default_rng(0)
    start = {n: rng.normal(size=s).astype(np.float32)
             for n, s in OPT_SPEC.items()}
    cfg = _cfg(port_config, regime)
    jcfg = _cfg(jax_config, regime)
    params = _tree(start)
    tx = jax_trainer.make_optimizer(jcfg, params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    module = _opt_module(start)
    opt = trainer.make_optimizer(cfg, module)
    named = dict(module.named_parameters())
    out = []
    for g in seq:
        updates, opt_state = update(_tree(g), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for n, p in named.items():
            p.grad = torch.tensor(g[n]) if p.requires_grad else None
        opt.step()
        out.append(({n: np.asarray(v) for n, v in _flatten_tree(params)},
                    {n: p.detach().numpy().copy() for n, p in named.items()}))
    return start, out, opt


def _flatten_tree(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten_tree(val, prefix + (key,))
        else:
            yield ".".join(prefix + (key,)), val


@pytest.mark.parametrize("regime", REGIMES)
def test_optimizer_trajectory_matches_optax(regime):
    """Six steps, one clipped (gradients x50) and one with a NaN in a
    trainable gradient (skipped), against the JAX package's optax chain on
    the same gradients: rtol 2e-5, atol 2e-6 (the AdamW conventions differ
    only in rounding: torch decays, then adds the moment ratio; optax adds
    both at once); frozen parameters bit-identical to their start."""
    start, steps, opt = _run_both(regime, _grad_seq(6, big_step=2,
                                                    nan_steps=(4,)))
    labels = trainer.param_labels(_opt_module(start), regime)
    for k, (ref, ours) in enumerate(steps):
        for name in OPT_SPEC:
            np.testing.assert_allclose(ours[name], ref[name], rtol=2e-5,
                                       atol=2e-6, err_msg=f"{k} {name}")
            if labels[name] == "freeze":
                np.testing.assert_array_equal(ours[name], start[name])
    # the NaN step moved nothing and did not advance Adam's step count
    for name in OPT_SPEC:
        np.testing.assert_array_equal(steps[4][1][name], steps[3][1][name])
    counts = {int(s["step"]) for s in opt.adamw.state.values()}
    assert counts == {5} and opt.notfinite_count == 0


def test_guard_gives_up_after_100_consecutive_errors():
    """optax.apply_if_finite(max_consecutive_errors=100): the 101st
    non-finite step in a row is applied (and poisons the parameters), in
    both packages at the same step."""
    seq = _grad_seq(102, nan_steps=range(1, 102))
    _, steps, opt = _run_both("joint", seq)
    for k in (1, 100):
        ref, ours = steps[k]
        assert np.isfinite(ours["ltsf.dense.bias"]).all(), k
        assert np.isfinite(ref["ltsf.dense.bias"]).all(), k
    ref, ours = steps[101]
    assert np.isnan(ours["ltsf.dense.bias"]).all()
    assert np.isnan(ref["ltsf.dense.bias"]).all()
    assert opt.notfinite_count == 101


# --------------------------------------------------------------------------
# run_stage2 on the CPU
# --------------------------------------------------------------------------

JAX_METRIC_KEYS = {"test_ade", "test_fde", "min_ade", "min_fde", "min_rmse",
                   "K"}   # tsue_tpu/runner.py:450-455


def test_run_stage2_on_the_cpu_is_reproducible(tmp_path):
    """One epoch of the frozen-MLLM regime with dropout live and the fused
    switch on, then the test metrics with K = 2 candidates: the JAX
    package's keys, finite, and equal over two runs with the same seed."""
    from tsue_tpu_torch.runner import run_stage2
    cfg = _cfg(port_config, "frozen_mllm", dropout=0.1)
    runs = []
    with fused_scope("on"):
        for i in range(2):
            runs.append(run_stage2(cfg, out_dir=str(tmp_path / str(i)),
                                   epochs=1, eval_candidates=2,
                                   synthetic_tracks=10, device="cpu"))
    assert set(runs[0]) == JAX_METRIC_KEYS
    assert all(np.isfinite(v) for v in runs[0].values())
    assert runs[0] == runs[1]
    assert (tmp_path / "0" / cfg.name / "metrics.jsonl").exists()
