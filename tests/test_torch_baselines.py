"""The seven comparison baselines in the port against the JAX package, on
the CPU.

Inputs come from a numpy seed (normalised trajectories, lane polygons in
pixels around the window, a wrap-padded row); weights too, filled into the
shape of each Flax module's variables (``jax.eval_shape`` of its init, so
no init is compiled) and carried across by ``convert.load_flax_params``
and ``load_flax_batch_stats``.  Checked, at narrow widths (hidden 32,
MMTrans d_model 32 with 2 heads of 16 and 2 layers):

- every deterministic forward within atol 1e-5: CS-LSTM teacher-forced and
  autoregressive, Social-LSTM, STGCNN with running and with batch
  statistics (and the running statistics that forward leaves), Trajectron
  with z = mu, MMTrans with its key mask over zero lane points, the GAIL
  generator and discriminator; ``cv_candidates`` without noise and
  ``kl_divergence``;
- one train step (CS-LSTM, Social-LSTM, STGCNN, MMTrans at dropout 0, and
  GAIL's D-then-G step) against optax, at ``tests/test_torch_train.py``'s
  tolerances: the loss within rtol 1e-4; an updated element within atol
  2e-6, or 2 * lr where its gradient is near Adam's eps (below 1e-4, or
  below 1e-3 of its tensor's largest), since Adam moves every element by
  about lr whatever its gradient's size; STGCNN's running statistics
  within atol 1e-5;
- STGCNN's K train-mode candidates against the JAX package's vmapped
  ones (each candidate's statistics over its own rows) and its running
  statistics untouched by them;
- ``run_baseline`` end to end for all seven names on the CPU, and the
  ``baseline`` command.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tsue_tpu.models import baselines as jb
from tsue_tpu.train import baseline_steps as jsteps
from tsue_tpu_torch.convert import load_flax_batch_stats, load_flax_params
from tsue_tpu_torch.models import baselines as pb
from tsue_tpu_torch.runner import run_baseline
from tsue_tpu_torch.train import baseline_steps as psteps

T_IN, T_OUT, B, P = 6, 6, 8, 64
LR, WD = 1e-3, 1e-4
ATOL = 1e-5
RNGS = {"params": jax.random.key(0), "dropout": jax.random.key(1),
        "latent": jax.random.key(2), "noise": jax.random.key(3)}
# the registry models at narrow widths, the same arguments on both sides
MODELS = {
    "cs_lstm": dict(hidden_dim=32),
    "social_lstm": dict(hidden_dim=32),
    "stgcnn": dict(hidden_dim=32),
    "trajectron": dict(hidden_dim=32),
    "mmtrans": dict(d_model=32, n_heads=2, n_layers=2, dropout=0.0),
}
RESULT_KEYS = {"test_ade", "test_fde", "min_ade", "min_fde", "min_rmse", "K"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(seed=0):
    """A test batch: trajectories in [0, 1], the window's pixel box, a lane
    polygon around it (lengths 0, P and between), the last row padding."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 3000, (B, 2))
    span = rng.uniform(50, 500, (B, 2))
    ns = np.stack([lo[:, 0], lo[:, 0] + span[:, 0], lo[:, 1],
                   lo[:, 1] + span[:, 1]], 1)
    lens = rng.integers(1, P, B)
    lens[0], lens[1] = 0, P
    poly = lo[:, None] + rng.uniform(-0.5, 1.5, (B, P, 2)) * span[:, None]
    valid = np.ones(B, bool)
    valid[-1] = False
    out = {"traj_in": rng.uniform(0, 1, (B, 2, T_IN)),
           "traj_out": rng.uniform(0, 1, (B, 2, T_OUT)),
           "polygon": poly, "polygon_len": lens, "norm_stat": ns,
           "valid": valid}
    return {k: v.astype(np.float32) if v.dtype == np.float64
            else v.astype(np.int32) if v.dtype == np.int64 else v
            for k, v in out.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _random_variables(init, seed):
    """Flax variables in the shape ``init`` gives, from a numpy seed:
    kernels N(0, 1 / fan-in), biases N(0, 0.1), norm scales 1 + N(0,
    0.1), running means N(0, 0.1), running variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            x = 0.1 * rng.standard_normal(shape)
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


def _port(model, variables):
    load_flax_params(model, variables["params"])
    if "batch_stats" in variables:
        load_flax_batch_stats(model, variables["batch_stats"])
    return model


@pytest.fixture(scope="module")
def setup():
    """{name: (JAX module, variables, port module)} for the registry models
    and GAIL's pair, and the batch."""
    batch = _batch()
    jbatch = _jb(batch)
    out = {}
    for i, (name, kw) in enumerate(MODELS.items()):
        jm = jb.BASELINE_REGISTRY[name](seq_len=T_IN, out_len=T_OUT, **kw)
        vs = _random_variables(lambda: jm.init(RNGS, jbatch, True), i)
        pm = pb.BASELINE_REGISTRY[name](seq_len=T_IN, out_len=T_OUT, **kw)
        out[name] = (jm, vs, _port(pm, vs))
    jg = jb.GAILGenerator(T_IN, T_OUT)
    jd = jb.GAILDiscriminator(T_IN, T_OUT)
    out["gail_generator"] = (jg, _random_variables(
        lambda: jg.init(RNGS, jbatch, True), 10), None)
    out["gail_discriminator"] = (jd, _random_variables(
        lambda: jd.init(RNGS, jbatch["traj_in"], jbatch["traj_out"]), 11),
        None)
    for name, cls in (("gail_generator", pb.GAILGenerator),
                      ("gail_discriminator", pb.GAILDiscriminator)):
        jm, vs, _ = out[name]
        out[name] = (jm, vs, _port(cls(T_IN, T_OUT), vs))
    return out, batch


def _fresh(setup, name):
    """A new port module with the case's starting weights (train steps and
    train-mode forwards change them)."""
    models, _ = setup
    jm, vs, _ = models[name]
    if name.startswith("gail"):
        cls = (pb.GAILGenerator if name == "gail_generator"
               else pb.GAILDiscriminator)
        return _port(cls(T_IN, T_OUT), vs)
    return _port(pb.BASELINE_REGISTRY[name](seq_len=T_IN, out_len=T_OUT,
                                            **MODELS[name]), vs)


FORWARDS = ["cs_lstm_teacher", "cs_lstm_autoregressive", "social_lstm",
            "stgcnn_eval", "stgcnn_train", "trajectron", "mmtrans",
            "gail_generator", "gail_discriminator"]


@pytest.mark.parametrize("case", FORWARDS)
def test_forward_matches_jax(setup, case):
    """The deterministic forward of every baseline module within atol
    1e-5 (STGCNN also in train mode, with the running statistics it
    leaves; Trajectron's deterministic forward takes z = mu)."""
    models, batch = setup
    name = {"cs_lstm_teacher": "cs_lstm", "cs_lstm_autoregressive": "cs_lstm",
            "stgcnn_eval": "stgcnn", "stgcnn_train": "stgcnn"}.get(case, case)
    jm, vs, _ = models[name]
    pm = _fresh(setup, name)
    jbatch, tbatch = _jb(batch), _tb(batch)
    stats = None
    with torch.no_grad():
        if case == "gail_discriminator":
            ref = jm.apply(vs, jbatch["traj_in"], jbatch["traj_out"])
            out = pm(tbatch["traj_in"], tbatch["traj_out"])
        elif case == "cs_lstm_teacher":
            ref = jax.jit(lambda v, b: jm.apply(v, b, True,
                                                teacher=b["traj_out"]))(
                vs, jbatch)
            out = pm(tbatch, teacher=tbatch["traj_out"])
        elif case == "stgcnn_train":
            ref, stats = jax.jit(lambda v, b: jm.apply(
                v, b, False, mutable=["batch_stats"]))(vs, jbatch)
            out = pm(tbatch, deterministic=False)
        else:
            ref = jax.jit(lambda v, b: jm.apply(v, b, True))(vs, jbatch)
            out = pm(tbatch)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    if stats is not None:
        for blk in ("stgconv1", "stgconv2"):
            norm = pm.get_submodule(f"{blk}.norm")
            ref_s = stats["batch_stats"][blk]["norm"]
            np.testing.assert_allclose(norm.running_mean.numpy(),
                                       np.asarray(ref_s["mean"]), atol=ATOL)
            np.testing.assert_allclose(norm.running_var.numpy(),
                                       np.asarray(ref_s["var"]), atol=ATOL)


def test_cv_candidates_and_kl_match_jax():
    """``cv_candidates`` without noise (K = 3 equal candidates) and
    ``kl_divergence`` against the JAX functions."""
    batch = _batch(1)
    ref = jb.cv_candidates(jnp.asarray(batch["traj_in"]), T_OUT, None, 3)
    out = pb.cv_candidates(torch.from_numpy(batch["traj_in"]), T_OUT, None, 3)
    assert out.shape == (B, 3, 2, T_OUT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    rng = np.random.default_rng(2)
    mu, logvar = (rng.standard_normal((B, 32)).astype(np.float32)
                  for _ in range(2))
    from tsue_tpu.models.baselines.trajectron import kl_divergence as jkl
    from tsue_tpu_torch.models.baselines.trajectron import kl_divergence
    np.testing.assert_allclose(
        float(kl_divergence(torch.from_numpy(mu), torch.from_numpy(logvar))),
        float(jkl(jnp.asarray(mu), jnp.asarray(logvar))), rtol=1e-6)
    # with a generator: K noisy candidates around the noise-free one
    g = torch.Generator().manual_seed(0)
    noisy = pb.cv_candidates(torch.from_numpy(batch["traj_in"]), T_OUT, g, 4)
    assert not torch.equal(noisy[:, 0], noisy[:, 1])


def _zero_grad(pname: str) -> bool:
    """Biases whose gradient is 0 in exact arithmetic: a conv's bias before
    a train-mode BatchNorm, which subtracts every channel's batch mean, and
    the attention key biases (a shift common to all keys, as
    ``tests/test_torch_train.py`` notes).  Both packages compute rounding
    noise (~1e-6 of the model's largest gradient) whose sign Adam's first
    step follows, by lr, so each package must move every element by at
    most lr (and weight decay's lr * wd * |value|)."""
    return pname.endswith((".k.bias", "conv.bias"))


def _assert_step(name, params, grads, ref_params, start):
    """Updated parameters against optax's, by ``tests/test_torch_train.py``'s
    rule: atol 2 * lr where the gradient is near Adam's eps, else 2e-6
    (``_zero_grad``: each side's move within lr)."""
    for pname, p in params.items():
        r = ref_params[pname]
        if _zero_grad(pname):
            for moved in (p.detach().numpy(), r):
                assert np.abs(moved - start[pname]).max() <= LR * 1.001, pname
            continue
        g = np.abs(grads[pname])
        small = (g < 1e-4) | (g < 1e-3 * g.max())
        out = p.detach().numpy()
        np.testing.assert_allclose(out[~small], r[~small], rtol=0, atol=2e-6,
                                   err_msg=f"{name}: {pname}")
        np.testing.assert_allclose(out[small], r[small], rtol=0,
                                   atol=2 * LR, err_msg=f"{name}: {pname}")


def _port_named(model, tree, convert=load_flax_params):
    """A Flax tree in the port's names and layouts, via a copy of the
    module loaded with it."""
    import copy
    m = convert(copy.deepcopy(model), tree)
    return {n: p.detach().numpy() for n, p in m.named_parameters()}


@pytest.mark.parametrize("name", ["cs_lstm", "social_lstm", "stgcnn",
                                  "mmtrans"])
def test_train_step_matches_optax(setup, name):
    """One ``make_baseline_train_step`` (AdamW(lr, weight_decay)) against
    the JAX step and optax.adamw: the loss, every updated parameter and
    STGCNN's running statistics."""
    models, batch = setup
    jm, vs, _ = models[name]
    tx = optax.adamw(LR, weight_decay=WD)
    new_vs, _, m = jax.jit(jsteps.make_baseline_train_step(jm, tx))(
        dict(vs), tx.init(vs["params"]), _jb(batch), jax.random.key(0))
    pm = _fresh(setup, name)
    start = {n: p.detach().numpy().copy() for n, p in pm.named_parameters()}
    opt = torch.optim.AdamW(pm.parameters(), lr=LR, weight_decay=WD,
                            eps=1e-8)
    loss = psteps.make_baseline_train_step(pm, opt)(
        _tb(batch), torch.Generator().manual_seed(0))["loss"]
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-4)
    params = dict(pm.named_parameters())
    grads = {n: p.grad.numpy() for n, p in params.items()}
    _assert_step(name, params, grads,
                 _port_named(pm, jax.device_get(new_vs["params"])), start)
    if name == "stgcnn":
        for blk in ("stgconv1", "stgconv2"):
            norm = pm.get_submodule(f"{blk}.norm")
            ref_s = new_vs["batch_stats"][blk]["norm"]
            np.testing.assert_allclose(norm.running_mean.numpy(),
                                       np.asarray(ref_s["mean"]), atol=ATOL)
            np.testing.assert_allclose(norm.running_var.numpy(),
                                       np.asarray(ref_s["var"]), atol=ATOL)


def test_gail_step_matches_optax(setup):
    """``make_gail_train_step``: D's update, then G's against the updated
    D, both Adam(lr), against the JAX step: D's and G's losses and every
    updated parameter of both."""
    models, batch = setup
    jg, gvs, _ = models["gail_generator"]
    jd, dvs, _ = models["gail_discriminator"]
    g_tx, d_tx = optax.adam(LR), optax.adam(LR)
    gp, dp, _, _, m = jax.jit(jsteps.make_gail_train_step(jg, jd, g_tx,
                                                          d_tx))(
        gvs["params"], dvs["params"], g_tx.init(gvs["params"]),
        d_tx.init(dvs["params"]), _jb(batch), jax.random.key(0))
    gen, disc = _fresh(setup, "gail_generator"), _fresh(setup,
                                                        "gail_discriminator")
    start = {mod: {n: p.detach().numpy().copy()
                   for n, p in mod.named_parameters()} for mod in (gen, disc)}
    got = psteps.make_gail_train_step(
        gen, disc, torch.optim.Adam(gen.parameters(), lr=LR),
        torch.optim.Adam(disc.parameters(), lr=LR))(_tb(batch))
    for key in ("d_loss", "g_loss", "mse", "adv"):
        np.testing.assert_allclose(float(got[key]), float(m[key]),
                                   rtol=1e-4, err_msg=key)
    for mod, tree in ((gen, gp), (disc, dp)):
        params = dict(mod.named_parameters())
        _assert_step(type(mod).__name__, params,
                     {n: p.grad.numpy() for n, p in params.items()},
                     _port_named(mod, jax.device_get(tree)), start[mod])


def test_stgcnn_candidates_match_jax_and_keep_the_statistics(setup):
    """``make_baseline_eval_fn`` on STGCNN: each of the K train-mode
    candidates normalises by its own batch statistics, as the JAX package's
    vmapped candidates do (within atol 1e-5), and the running statistics
    are as they were before the candidates."""
    models, batch = setup
    jm, vs, _ = models["stgcnn"]
    ref = jax.jit(jsteps.make_baseline_eval_fn(jm), static_argnums=3)(
        vs, _jb(batch), jax.random.key(0), 3)
    pm = _fresh(setup, "stgcnn")
    before = {n: b.clone() for n, b in pm.named_buffers()}
    out = psteps.make_baseline_eval_fn(pm)(_tb(batch),
                                           torch.Generator().manual_seed(0), 3)
    assert out.shape == (B, 3, 2, T_OUT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)
    for n, b in pm.named_buffers():
        assert torch.equal(b, before[n]), n


def _run_cfg():
    import dataclasses
    from tsue_tpu_torch.config import get_preset
    cfg = get_preset("ablation_no_llm")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=4))


@pytest.mark.parametrize("name", pb.BASELINE_NAMES)
def test_run_baseline_on_the_cpu(tmp_path, name):
    """``run_baseline`` for every name on the CPU (preset
    "ablation_no_llm", 6->30, one epoch, K = 2, three synthetic tracks):
    the JAX package's keys, finite values, the metrics stream and, for
    the registry models, the candidate plot."""
    out = run_baseline(name, _run_cfg(), out_dir=str(tmp_path), epochs=1,
                       eval_candidates=2, synthetic_tracks=3, device="cpu")
    assert set(out) == RESULT_KEYS and out["K"] == 2
    assert all(np.isfinite(v) for v in out.values())
    run = tmp_path / f"baseline_{name}"
    assert (run / "metrics.jsonl").exists()
    plot = run / "viz" / f"{name}_candidates_0.png"
    assert plot.exists() == (name in pb.BASELINE_REGISTRY)


def test_baseline_command(tmp_path, capsys):
    """``python -m tsue_tpu_torch.cli baseline`` prints its result as one
    JSON line; an unknown ``--name`` is refused before any work."""
    from tsue_tpu_torch.cli.__main__ import main
    argv = ["baseline", "--device", "cpu", "--epochs", "1", "--batch-size",
            "4", "--synthetic-tracks", "3", "--out-dir", str(tmp_path)]
    got = main(argv + ["--name", "stgcnn", "--k", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert set(got) == RESULT_KEYS
    with pytest.raises(SystemExit):
        main(argv + ["--name", "lstm"])
    assert sorted(os.listdir(tmp_path)) == ["baseline_stgcnn"]


def test_run_baseline_wants_the_card():
    """Without ``device="cpu"``, ``run_baseline`` wants the CUDA device and
    raises on a host without one."""
    import inspect
    assert inspect.signature(run_baseline).parameters["device"].default == \
        "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_baseline("cv", _run_cfg(), epochs=0)
