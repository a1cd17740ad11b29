"""The DDPM trajectory generator in the port against the JAX package, on
the CPU.

The UNet runs at 16 channels and a 32-wide condition over T = 6 (the
bottleneck's cross-attention: 1 head of 16, 6 queries over one key);
weights come from a numpy seed in the shape of the Flax init
(``jax.eval_shape``, so no init is compiled) and cross through
``convert.load_flax_params`` (the Flax (3, C_in, C_out) conv kernels to
``Conv1d``'s (C_out, C_in, 3)).  Checked:

- ``make_beta_schedule`` (linear, cosine) and every ``DDPMSchedule``
  array bit-identical to the JAX package's;
- ``q_sample``, ``p_mean_variance`` and one reverse step with a given z
  (t > 0 and t = 0), and the UNet's CFG forward, within atol 1e-5;
- the train loss with the JAX step's own draws passed explicitly, within
  rel 1e-5, and the Adam step after it (coupled L2 1e-4, the JAX package's
  ``add_decayed_weights`` then ``adam``) at ``tests/test_torch_train.py``'s
  tolerances; ``ema_update`` within atol 1e-7;
- a 20-step ``p_sample_loop`` that repeats bit for bit from the same
  generator, finite, of shape (2 n, 2, T);
- ``run_diffusion`` end to end on the CPU and the ``diffusion`` command.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tsue_tpu.models import diffusion as jd
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.models import diffusion as pd
from tsue_tpu_torch.runner import run_diffusion

B, T, C, COND = 4, 6, 16, 32     # B rows a half: the model sees 2B
LR = 1e-4
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def unet():
    """(JAX module, its params, a port module loaded with them)."""
    jm = jd.ConditionalUNet(base_channels=C, cond_dim=COND)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0)}, jnp.zeros((2 * B, 2, T)),
        jnp.zeros((2 * B, COND))))["params"]
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            return _np(rng, *leaf.shape,
                       scale=float(np.prod(leaf.shape[:-1])) ** -0.5)
        return _np(rng, *leaf.shape, scale=0.1)
    params = jax.tree_util.tree_map_with_path(fill, shapes)
    port = load_flax_params(pd.ConditionalUNet(cond_dim=COND,
                                               base_channels=C), params)
    return jm, params, port


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedule_bit_identical(kind):
    for n in (50, 1000):
        np.testing.assert_array_equal(pd.make_beta_schedule(kind, n),
                                      jd.make_beta_schedule(kind, n))
        ours, ref = pd.DDPMSchedule.create(kind, n), jd.DDPMSchedule.create(
            kind, n)
        for field in ("betas", "alphas_cum", "alphas_cum_prev",
                      "sqrt_alphas_cum", "sqrt_one_minus_alphas_cum",
                      "posterior_var"):
            np.testing.assert_array_equal(getattr(ours, field),
                                          getattr(ref, field), err_msg=field)
        assert ours.n_timestep == n
    with pytest.raises(ValueError):
        pd.make_beta_schedule("sigmoid", 10)


def test_q_sample_and_p_mean_variance_match_jax():
    sched_p, sched_j = (pd.DDPMSchedule.create("cosine", 50),
                        jd.DDPMSchedule.create("cosine", 50))
    rng = np.random.default_rng(1)
    x0, noise, pred = (_np(rng, 2 * B, 2, T) for _ in range(3))
    t = np.array([0, 1, 7, 20, 33, 48, 49, 49], np.int32)
    ref = jd.q_sample(sched_j, jnp.asarray(x0), jnp.asarray(t),
                      jnp.asarray(noise))
    out = pd.q_sample(sched_p, torch.from_numpy(x0),
                      torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # x_t far outside [-1, 1] so the x0 clamp bites
    xt = 3 * x0
    mean_j, var_j = jd.p_mean_variance(sched_j, jnp.asarray(pred),
                                       jnp.asarray(xt), jnp.asarray(t))
    mean_p, var_p = pd.p_mean_variance(sched_p, torch.from_numpy(pred),
                                       torch.from_numpy(xt),
                                       torch.from_numpy(t).long())
    np.testing.assert_allclose(mean_p.numpy(), np.asarray(mean_j), atol=ATOL)
    np.testing.assert_allclose(var_p.numpy(), np.asarray(var_j), atol=ATOL)


def test_unet_cfg_forward_matches_jax(unet):
    jm, params, port = unet
    rng = np.random.default_rng(2)
    x, cond = _np(rng, 2 * B, 2, T), _np(rng, 2 * B, COND)
    for scale in (3.0, 0.0):
        ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                       scale)
        with torch.no_grad():
            out = port(torch.from_numpy(x), torch.from_numpy(cond), scale)
        assert out.shape == (2 * B, 2, T)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("t", [7, 0])
def test_reverse_step_matches_jax(unet, t):
    """One reverse step from x_t with a given z, as ``p_sample_loop``'s
    body takes it (at t = 0 the mean alone)."""
    jm, params, port = unet
    sched_p, sched_j = (pd.DDPMSchedule.create("cosine", 50),
                        jd.DDPMSchedule.create("cosine", 50))
    rng = np.random.default_rng(3)
    x, cond, z = _np(rng, 2 * B, 2, T), _np(rng, 2 * B, COND), _np(
        rng, 2 * B, 2, T)
    pred = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond),
                    3.0)
    mean, var = jd.p_mean_variance(sched_j, pred, jnp.asarray(x),
                                   jnp.full((2 * B,), t, jnp.int32))
    ref = jnp.where(t > 0, mean + jnp.sqrt(var) * jnp.asarray(z), mean)
    with torch.no_grad():
        out = pd.p_sample_step(port, sched_p, torch.from_numpy(x), t,
                               torch.from_numpy(cond), torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_train_loss_and_step_match_jax(unet):
    """The JAX step's loss from its own draws (``diffusion.py:201-207``'s
    splits) equals ``diffusion_loss`` on the same arrays, and one Adam
    step with coupled L2 moves the parameters as optax's chain does."""
    jm, params, port = unet
    sched_p, sched_j = (pd.DDPMSchedule.create("cosine", 50),
                        jd.DDPMSchedule.create("cosine", 50))
    rng = np.random.default_rng(4)
    x0, cond = _np(rng, B, 2, T), _np(rng, B, COND)
    key = jax.random.key(5)
    tx = optax.chain(optax.add_decayed_weights(1e-4), optax.adam(LR))
    new_params, _, _, m = jax.jit(jd.make_diffusion_train_step(
        jm, sched_j, tx))(params, tx.init(params), params, jnp.asarray(x0),
                          jnp.asarray(cond), key)
    r1, r2, r3 = jax.random.split(key, 3)
    uncond = 0.05 * jax.random.normal(r1, cond.shape)
    t = jax.random.randint(r2, (2 * B,), 0, sched_j.n_timestep)
    noise = jax.random.normal(r3, (2 * B, 2, T))
    model = copy.deepcopy(port)
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    loss = pd.diffusion_loss(
        model, sched_p, torch.from_numpy(x0), torch.from_numpy(cond),
        torch.from_numpy(np.array(uncond)),
        torch.from_numpy(np.array(t)).long(),
        torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(float(loss.detach()), float(m["loss"]),
                               rtol=1e-5)
    opt = torch.optim.Adam(model.parameters(), lr=LR, weight_decay=1e-4)
    loss.backward()
    opt.step()
    ref = load_flax_params(copy.deepcopy(port), jax.device_get(new_params))
    for (name, p), (_, r) in zip(model.named_parameters(),
                                 ref.named_parameters()):
        out, r = p.detach().numpy(), r.detach().numpy()
        g = np.abs(p.grad.numpy())
        small = (g < 1e-4) | (g < 1e-3 * g.max())
        np.testing.assert_allclose(out[~small], r[~small], rtol=0, atol=2e-6,
                                   err_msg=name)
        np.testing.assert_allclose(out[small], r[small], rtol=0, atol=2 * LR,
                                   err_msg=name)
        assert not np.array_equal(out, start[name]), name


def test_ema_update_matches_jax(unet):
    _, params, port = unet
    rng = np.random.default_rng(6)
    other = jax.tree.map(lambda p: _np(rng, *p.shape), params)
    ref = jd.ema_update(params, other)
    shadow = copy.deepcopy(port)
    pd.ema_update(shadow, load_flax_params(copy.deepcopy(port), other))
    want = load_flax_params(copy.deepcopy(port), jax.device_get(ref))
    for (name, s), (_, r) in zip(shadow.named_parameters(),
                                 want.named_parameters()):
        np.testing.assert_allclose(s.detach().numpy(), r.detach().numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)


def test_p_sample_loop_repeats_bit_for_bit(unet):
    """20 reverse steps: finite, (2 n, 2, T), and the same bits from the
    same generator seed (another seed gives another chain)."""
    _, _, port = unet
    sched = pd.DDPMSchedule.create("cosine", 20)
    cond = torch.zeros(2 * 3, COND)

    def chain(seed):
        return pd.p_sample_loop(port, sched, (6, 2, T), cond,
                                torch.Generator().manual_seed(seed))
    first, again, other = chain(7), chain(7), chain(8)
    assert first.shape == (6, 2, T)
    assert torch.isfinite(first).all()
    assert torch.equal(first, again)
    assert not torch.equal(first, other)


def _run_cfg():
    import dataclasses
    from tsue_tpu_torch.config import get_preset
    cfg = get_preset("mllm_free_18_18")
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=4))


def test_run_diffusion_on_the_cpu(tmp_path):
    """``run_diffusion`` on the CPU (preset "mllm_free_18_18", one epoch,
    20 timesteps, 2 samples): the JAX package's keys, finite values, the
    metrics stream and the samples' X/Y-over-time plot."""
    out = run_diffusion(_run_cfg(), out_dir=str(tmp_path), epochs=1,
                        n_timestep=20, n_samples=2, synthetic_tracks=3,
                        device="cpu")
    assert set(out) == {"final_diff_loss", "samples"}
    assert np.isfinite(out["final_diff_loss"]) and out["samples"] == 2
    assert (tmp_path / "diffusion" / "metrics.jsonl").exists()
    assert (tmp_path / "diffusion" / "viz" / "ddpm_samples_0.png").exists()


def test_diffusion_command(tmp_path, capsys):
    """``python -m tsue_tpu_torch.cli diffusion`` (generate mode) prints its
    result as one JSON line."""
    from tsue_tpu_torch.cli.__main__ import main
    got = main(["diffusion", "--device", "cpu", "--epochs", "1",
                "--batch-size", "4", "--synthetic-tracks", "3",
                "--timesteps", "10", "--samples", "2",
                "--out-dir", str(tmp_path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert set(got) == {"final_diff_loss", "samples"}


def test_run_diffusion_wants_the_card():
    """Without ``device="cpu"``, ``run_diffusion`` wants the CUDA device
    and raises on a host without one."""
    import inspect
    assert inspect.signature(run_diffusion).parameters["device"].default \
        == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_diffusion(_run_cfg(), epochs=0)
