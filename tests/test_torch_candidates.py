"""The parity candidate mode in the port against the JAX package:
``eval.metrics.candidate_rollout`` (K whole stochastic forwards) and the
routing of ``runner.evaluate``.

The model is a tiny TrajectoryModel (Llama 2 layers of 64, Q-Former 1 + 1
layers of 32, lane encoder and LTSF 16 wide) on seq 6 -> 6 windows, the
lane polygons in kilopixels (raw pixel polygons saturate the lane
attention at random init, whose output is then set by fp32 rounding and
differs between any two orders of summation).  Torch cannot reproduce
JAX's dropout masks, so the packages are compared where they compute the
same thing:

- every dropout rate 0: each of the port's K candidates equals the JAX
  deterministic forward on the same weights (Flax init carried across by
  ``convert.load_flax_params``) within atol = rtol = 1e-4;
- a model without the LLM: ``evaluate``'s deterministic ``test_ade`` and
  ``test_fde`` equal the JAX ``evaluate``'s within relative 1e-4 (pixels,
  sums in other orders), and both take the parity route;
- statistics: after a short joint training in the port (12 synthetic
  tracks of 600 frames, 6 epochs at batch 8, lr 5e-4, every dropout 0.1),
  the mean over 15 eval seeds of min ADE / FDE / RMSE (K = 10) of each of
  the port's modes agrees within 10% with the JAX package's same mode on
  the same weights (carried back to Flax by inverting ``convert``'s leaf
  layouts).  The 10% agreement of the fast mode with the parity mode
  (``tests/test_fast_vs_parity.py:75``) is not asserted: on these weights
  the JAX package itself misses it (ROADMAP C, with the numbers).
Within the port, candidates are checked bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu.data.windowing import WindowedDataset as JaxWindowedDataset
from tsue_tpu.eval import metrics as jax_metrics
from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
from tsue_tpu.parallel.mesh import make_mesh
from tsue_tpu.runner import evaluate as jax_evaluate
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch import runner
from tsue_tpu_torch.convert import _convert_leaf, _flatten, load_flax_params
from tsue_tpu_torch.data import BatchIterator, ByteTokenizer
from tsue_tpu_torch.eval.metrics import (candidate_rollout,
                                         fast_candidate_rollout)
from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
from tsue_tpu_torch.train.trainer import (TrainState, make_optimizer,
                                          make_train_step)
from tsue_tpu_torch.utils.random import step_generator

K = 10
TOL = dict(atol=1e-4, rtol=1e-4)
# the statistics test: the sizes and the training seed were fixed before
# its first run; 3 eval seeds left min FDE's seed-to-seed spread (10-18% of
# its mean) above the 10% bound, so it takes 15 (ROADMAP C)
STAT_TRACKS, STAT_EPOCHS, STAT_LR = 12, 6, 5e-4
EVAL_SEEDS = tuple(5000 + 977 * s for s in range(15))
STAT_REL = 0.10


def _cfg(c, use_llm=True, llm_dropout=0.1, dropout=0.1, regime="joint",
         lr=5e-4):
    """The test configuration in the config classes of module ``c``:
    ``llm_dropout`` is the Q-Former's and the LoRA adapters',
    ``dropout`` the lane encoder's and the forecaster's."""
    return c.ExperimentConfig(
        name="torch_candidates",
        data=c.DataConfig(seq_len=6, out_len=6, max_length=64),
        model=c.ModelConfig(
            use_llm=use_llm,
            llama=dataclasses.replace(
                c.LlamaConfig.tiny(ByteTokenizer().vocab_size),
                lora_dropout=llm_dropout),
            qformer=c.QFormerConfig(hidden_size=32, num_heads=2,
                                    num_encoder_layers=1,
                                    num_decoder_layers=1,
                                    num_query_tokens=4, dropout=llm_dropout),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1,
                                     dropout=dropout),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16,
                              dropout=dropout)),
        train=c.TrainConfig(batch_size=8, freeze_regime=regime, lr=lr))


def _kilopixels(ds):
    return dataclasses.replace(ds, polygon=ds.polygon / 1000.0)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def splits():
    """The seeded split of 12 synthetic tracks of 600 frames (the data
    ``run_stage2(synthetic_tracks=12)`` builds), polygons in kilopixels."""
    cfg = _cfg(port_config)
    return tuple(_kilopixels(ds) for ds in runner.prepare_data(
        cfg, None, ByteTokenizer(), STAT_TRACKS))


def _batch(ds, i=0):
    return next(b for j, b in enumerate(BatchIterator(ds, 8, shuffle=False))
                if j == i)


def _tb(batch):
    return runner.to_device(batch, "cpu")


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flax_params(jcfg, batch):
    jmodel = JaxTrajectoryModel(jcfg.model, 6, 6)
    params = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
        False))(_jb(batch))["params"])
    return jmodel, params


def _port(cfg, params):
    return load_flax_params(TrajectoryModel(cfg.model, 6, 6), params)


@torch.no_grad()
def test_zero_dropout_candidates_equal_the_jax_forward(splits):
    """Every dropout rate 0: the K parity candidates are K copies of the
    JAX package's deterministic forward."""
    batch = _batch(splits[2])
    jmodel, params = _flax_params(
        _cfg(jax_config, llm_dropout=0.0, dropout=0.0), batch)
    ref = np.asarray(jax.jit(lambda p, b: jmodel.apply({"params": p}, b,
                                                       True))(params,
                                                              _jb(batch)))
    model = _port(_cfg(port_config, llm_dropout=0.0, dropout=0.0), params)
    cands = candidate_rollout(model, _tb(batch), 3, seed=5)
    assert tuple(cands.shape) == (8, 3, 2, 6)
    for k in range(3):
        np.testing.assert_allclose(cands[:, k].numpy(), ref, **TOL)


@pytest.fixture(scope="module")
def random_model(splits):
    """The port's model with random weights, every dropout 0.1."""
    cfg = _cfg(port_config)
    model = TrajectoryModel(cfg.model, 6, 6)
    return init_params(model, torch.Generator().manual_seed(0))


@torch.no_grad()
def test_candidate_k_is_its_own_stochastic_forward(splits, random_model):
    """Candidate k is ``model(b, False, generator=step_generator(seed,
    k))`` bit for bit, so it does not depend on K; candidates differ."""
    b = _tb(_batch(splits[2]))
    cands = candidate_rollout(random_model, b, 4, seed=7)
    for k in range(4):
        one = random_model(b, deterministic=False,
                           generator=step_generator(7, k))
        assert torch.equal(cands[:, k], one), k
    assert torch.equal(candidate_rollout(random_model, b, 2, seed=7),
                       cands[:, :2])
    for k in range(1, 4):
        assert not torch.allclose(cands[:, 0], cands[:, k])


@torch.no_grad()
def test_parity_mode_samples_the_llm_side(splits):
    """Lane and forecaster dropout 0, Q-Former and LoRA dropout 0.1: the
    parity candidates still differ (the LLM side's dropout), while every
    fast candidate equals the deterministic forecast (the port's form of
    ``tests/test_fast_vs_parity.py:80``)."""
    cfg = _cfg(port_config, llm_dropout=0.1, dropout=0.0)
    model = init_params(TrajectoryModel(cfg.model, 6, 6),
                        torch.Generator().manual_seed(0))
    b = _tb(_batch(splits[2]))
    par = candidate_rollout(model, b, 4, seed=3)
    fast = fast_candidate_rollout(model, b, 4, torch.Generator()
                                  .manual_seed(3))
    # the fast rollout forecasts K * B rows at once: the same rows as the
    # B of the deterministic forward, summed in another blocking
    torch.testing.assert_close(fast[:, 0], model(b), atol=1e-5, rtol=1e-5)
    for k in range(1, 4):
        assert torch.equal(fast[:, k], fast[:, 0]), k
    for k in range(1, 4):
        assert not torch.allclose(par[:, 0], par[:, k], atol=1e-6), k
    assert not torch.allclose(par[:, 0], fast[:, 0], atol=1e-6)


@pytest.mark.parametrize("use_llm,mode,route", [
    (True, "fast", "fast"), (True, "parity", "parity"),
    (False, "fast", "parity"), (False, "parity", "parity")])
def test_evaluate_routes_as_the_jax_package(splits, monkeypatch, use_llm,
                                           mode, route):
    """``candidate_mode == "fast"`` on a ``use_llm`` model takes the fast
    rollout, every other case the parity rollout seeded ``eval_seed + i``
    (``tsue_tpu/runner.py:400-406``)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, a[3] if name == "parity" else None))
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(runner, "candidate_rollout",
                        spy("parity", candidate_rollout))
    monkeypatch.setattr(runner, "fast_candidate_rollout",
                        spy("fast", fast_candidate_rollout))
    cfg = _cfg(port_config, use_llm=use_llm)
    model = init_params(TrajectoryModel(cfg.model, 6, 6),
                        torch.Generator().manual_seed(0))
    dte = splits[2].slice(np.arange(16))
    m = runner.evaluate(model, dte, cfg, 2, mode, eval_seed=40)
    assert m["K"] == 2 and np.isfinite(m["min_ade"])
    assert [c[0] for c in calls] == [route, route]
    if route == "parity":
        assert [c[1] for c in calls] == [40, 41]


def test_evaluate_without_the_llm_matches_jax(splits):
    """A ``use_llm=False`` model in fast mode: both packages take the
    parity route; the deterministic test metrics agree within relative
    1e-4 on the same weights, and both report the K-candidate keys."""
    dte = splits[2]
    jcfg = _cfg(jax_config, use_llm=False)
    jmodel, params = _flax_params(jcfg, _batch(dte))
    model = _port(_cfg(port_config, use_llm=False), params)
    ours = runner.evaluate(model, dte, _cfg(port_config, use_llm=False), K,
                           "fast")
    jdte = JaxWindowedDataset(**{f.name: getattr(dte, f.name)
                                 for f in dataclasses.fields(dte)})
    mesh = make_mesh(1)
    with mesh:
        ref = jax_evaluate(jmodel, params, jdte, jcfg, mesh, K, None, "fast")
    assert set(ours) == set(ref)
    for key in ("test_ade", "test_fde"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, atol=0)
    assert all(np.isfinite(ours[k]) and np.isfinite(ref[k])
               for k in ("min_ade", "min_fde", "min_rmse"))


# --------------------------------------------------------------------------
# statistics after a short joint training
# --------------------------------------------------------------------------

def _to_flax(model, template):
    """The port's parameters as a Flax tree shaped like ``template``: each
    leaf's layout change in ``convert`` is a reshape and a transpose, so
    converting the leaf's element indices gives, at each port position,
    the Flax position it came from."""
    modules = dict(model.named_modules())
    params = dict(model.named_parameters())
    out = {}
    for path, leaf in _flatten(template).items():
        mod = ".".join(path[:-1])
        idx = np.arange(leaf.size).reshape(leaf.shape)
        name, pos = _convert_leaf(modules[mod], path[-1], idx,
                                  "/".join(path))
        flat = np.empty(leaf.size, np.float32)
        flat[np.asarray(pos).ravel()] = \
            params[f"{mod}.{name}"].detach().numpy().ravel()
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = flat.reshape(leaf.shape)
    return out


@pytest.fixture(scope="module")
def trained(splits):
    """STAT_EPOCHS epochs of joint training in the port from init seed 0."""
    dtr = splits[0]
    cfg = _cfg(port_config, lr=STAT_LR)
    model = init_params(TrajectoryModel(cfg.model, 6, 6),
                        torch.Generator().manual_seed(0))
    state = TrainState(model, make_optimizer(cfg, model), cfg.train.seed)
    step = make_train_step(cfg)
    for epoch in range(STAT_EPOCHS):
        it = BatchIterator(dtr, 8, seed=cfg.train.seed)
        it.set_epoch(epoch)
        for b in it:
            step(state, _tb(b))
    return cfg, model


def _port_rows(trained, dte, mode):
    cfg, model = trained
    rows = []
    for seed in EVAL_SEEDS:
        m = runner.evaluate(model, dte, cfg, K, mode, eval_seed=seed)
        rows.append([m["min_ade"], m["min_fde"], m["min_rmse"]])
    return np.asarray(rows)


def _jax_rows(trained, dte, mode):
    """The JAX package's K-candidate metrics on the port's trained weights,
    accumulated as its ``evaluate`` accumulates them (batch i's key
    ``eval_seed + i``, sample-weighted), in one jitted program a batch."""
    cfg, model = trained
    jcfg = _cfg(jax_config, lr=STAT_LR)
    jmodel, template = _flax_params(jcfg, _batch(dte))
    params = _to_flax(model, template)

    @jax.jit
    def batch_metrics(p, b, key):
        if mode == "fast":
            cands = jax_metrics.fast_candidate_rollout(
                jmodel, {"params": p}, b, K, key)
        else:
            cands = jax_metrics.candidate_rollout(
                lambda v, bb, det, rngs: jmodel.apply(v, bb, det, rngs=rngs),
                {"params": p}, b, K, key)
        return jnp.stack(jax_metrics.min_ade_fde_rmse(
            cands, b["traj_out"], b["norm_stat"], b["valid"])), \
            b["valid"].sum()

    rows = []
    for seed in EVAL_SEEDS:
        sums, n = np.zeros(3), 0.0
        for i, b in enumerate(BatchIterator(dte, 8, shuffle=False)):
            m, nv = batch_metrics(params, _jb(b), jax.random.key(seed + i))
            sums += np.asarray(m, np.float64) * float(nv)
            n += float(nv)
        rows.append(sums / n)
    return np.asarray(rows)


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_statistics_match_jax(splits, trained, mode):
    """The mean min ADE / FDE / RMSE over the eval seeds: the port's mode
    against the JAX package's same mode, within 10%; the port's candidates
    differ from seed to seed."""
    dte = splits[2]
    ours, ref = _port_rows(trained, dte, mode), _jax_rows(trained, dte, mode)
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    assert (ours.std(axis=0) > 0).all()
    rel = np.abs(ours.mean(axis=0) - ref.mean(axis=0)) / ref.mean(axis=0)
    assert (rel < STAT_REL).all(), (
        f"{mode}: port {ours.mean(axis=0)}, JAX {ref.mean(axis=0)}, "
        f"rel {rel}")


def test_step_generator_depends_on_seed_and_step():
    """Each (seed, step) pair draws its own stream, on the CPU too, whose
    generator keeps only a seed's low 32 bits."""
    draws = {(s, k): torch.rand(4, generator=step_generator(s, k))
             for s in (0, 1, 5000, 5977) for k in (0, 1, 2)}
    for a in draws:
        for b in draws:
            if a != b:
                assert not torch.equal(draws[a], draws[b]), (a, b)
    assert torch.equal(draws[(5000, 1)],
                       torch.rand(4, generator=step_generator(5000, 1)))
