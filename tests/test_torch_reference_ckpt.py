"""The reference's own PyTorch checkpoints into the port and back
(``models/torch_import.py``, ``models/torch_export.py``,
``convert.flax_params``, the ``import_ref`` / ``export_ref`` commands), and
A.7's two drop-ins (``train/guard.py``, ``trainer.make_scan_epoch``), on
the CPU.

The reference-layout mirrors and their fixtures are
``tests/test_reference_ckpt_compat.py``'s (the reference's attribute
names, the HF Llama under the real ``peft.get_peft_model``).  On them:

- the port's import trees equal the JAX package's leaf for leaf and bit
  for bit, every checkpoint key is read and every port parameter filled;
- the port after import gives the mirrors' fused hidden state, stage-2
  prediction and loss within 1e-4;
- the port's exports equal the JAX package's key for key and bit for bit
  and load ``strict=True`` into the mirrors; ``import(export(m))`` is
  ``m`` bit for bit; ``flax_params`` inverts ``load_flax_params``;
- ``--strip-lora`` loads into a Llama without LoRA; an untied
  ``lm_head`` raises; the commands round-trip through ``cli.main``.

The guard's probes hold ``GuardedAdamW``'s trajectory bit for bit and
the JAX package's functions within the optimizer test's tolerance, skip
NaN and Inf, give up after ``MAX_CONSECUTIVE_ERRORS``; the scan epoch is
the step loop bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

# transformers would import TensorFlow, which nothing here uses
os.environ.setdefault("USE_TF", "0")
pytest.importorskip("peft")
pytest.importorskip("transformers")

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from test_reference_ckpt_compat import (  # noqa: F401  (fixtures)
    OUT_LEN, SEQ_LEN, VOCAB, RefLlamaMultiModal,
    RefMultiModalTrajectoryModel, _stage2_batch, cfgs, ref_module,
    ref_stage2, stage2_cfg)
from tsue_tpu.models import torch_export as jax_export
from tsue_tpu.models import torch_import as jax_import
from tsue_tpu.train import guard as jax_guard
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.cli import __main__ as cli
from tsue_tpu_torch.convert import _flatten, flax_params, load_flax_params
from tsue_tpu_torch.models import torch_export as te
from tsue_tpu_torch.models import torch_import as ti
from tsue_tpu_torch.models.fusion import MultiModalLLM
from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
from tsue_tpu_torch.train import trainer
from tsue_tpu_torch.train.guard import ClipNormGuardedAdamW, \
    MaxAbsGuardedAdamW
from tsue_tpu_torch.train.losses import denorm_mse_loss

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port_cfg(obj):
    """A JAX package config as the port's config classes (same fields)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(port_config, type(obj).__name__)
        return cls(**{f.name: _port_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def _assert_trees_equal(got, want):
    """Two Flax-path trees (nested dicts) equal, leaf for leaf, bit for
    bit."""
    a = _flatten(got)
    b = {k: np.asarray(v) for k, v in
         traverse_util.flatten_dict(want).items()}
    assert set(a) == set(b), sorted(set(a) ^ set(b))
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]),
                           torch.as_tensor(want[k])), k


@pytest.fixture(scope="module")
def port_cfgs(cfgs, stage2_cfg):
    llama, qformer = cfgs
    return _port_cfg(llama), _port_cfg(qformer), _port_cfg(stage2_cfg)


def _stage1_model(port_cfgs, sd):
    llama, qformer, _ = port_cfgs
    m = MultiModalLLM(llama, qformer)
    return load_flax_params(m, ti.convert_reference_mllm(sd, qformer, llama))


def _stage2_model(port_cfgs, sd):
    m = TrajectoryModel(port_cfgs[2], SEQ_LEN, OUT_LEN)
    return load_flax_params(m, ti.convert_reference_stage2(sd, port_cfgs[2]))


@pytest.fixture(scope="module")
def stage1_port(ref_module, port_cfgs):
    return _stage1_model(port_cfgs, ref_module.state_dict()).eval()


@pytest.fixture(scope="module")
def stage2_port(ref_stage2, port_cfgs):
    return _stage2_model(port_cfgs, ref_stage2.state_dict()).eval()


def _stage1_inputs():
    rng = np.random.default_rng(1)
    vision = rng.standard_normal((2, 3, 16)).astype(np.float32)
    ids = rng.integers(0, VOCAB, (2, 7))
    return vision, ids, np.ones((2, 7), np.int64)


def _port_batch():
    return {k: torch.from_numpy(v) for k, v in _stage2_batch().items()}


def _ref_stage2_pred(ref, b):
    with torch.no_grad():
        return ref(torch.tensor(b["traj_in"]), torch.tensor(b["vision"]),
                   torch.tensor(b["polygon"]),
                   torch.tensor(b["polygon_len"], dtype=torch.long),
                   torch.tensor(b["input_ids"], dtype=torch.long),
                   torch.tensor(b["attention_mask"], dtype=torch.long))


# --------------------------------------------------------------------------
# import
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_import_tree_and_keys_equal_the_jax_package(stage, ref_module,
                                                    ref_stage2, cfgs,
                                                    stage2_cfg, port_cfgs):
    """The same state dict through both importers: the trees equal bit for
    bit, and both read the same keys."""
    llama, qformer = cfgs
    got_keys, want_keys = set(), set()
    if stage == "stage1":
        sd = ref_module.state_dict()
        got = ti.convert_reference_mllm(sd, port_cfgs[1], port_cfgs[0],
                                        got_keys)
        want = jax_import.convert_reference_mllm(sd, qformer, llama,
                                                 want_keys)
    else:
        sd = ref_stage2.state_dict()
        got = ti.convert_reference_stage2(sd, port_cfgs[2], got_keys)
        want = jax_import.convert_reference_stage2(sd, stage2_cfg, SEQ_LEN,
                                                   OUT_LEN, want_keys)
    _assert_trees_equal(got, want)
    assert got_keys == want_keys


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_every_key_consumed_and_every_parameter_filled(stage, ref_module,
                                                       ref_stage2,
                                                       port_cfgs):
    """Every parameter key of the reference module is read (what is left
    is a buffer, which ``check_consumed`` passes), and the strict loader
    fills every parameter of the port's module."""
    ref = ref_module if stage == "stage1" else ref_stage2
    sd = ref.state_dict()
    consumed = set()
    if stage == "stage1":
        tree = ti.convert_reference_mllm(sd, port_cfgs[1], port_cfgs[0],
                                         consumed)
        model = MultiModalLLM(port_cfgs[0], port_cfgs[1])
    else:
        tree = ti.convert_reference_stage2(sd, port_cfgs[2], consumed)
        model = TrajectoryModel(port_cfgs[2], SEQ_LEN, OUT_LEN)
    params = {n for n, _ in ref.named_parameters()}
    assert params <= consumed, sorted(params - consumed)
    assert set(sd) - consumed <= {n for n, _ in ref.named_buffers()}
    ti.check_consumed(sd, consumed)
    with pytest.raises(KeyError, match="map to no parameter"):
        ti.check_consumed({**sd, "qformer.extra.weight": None}, consumed)
    load_flax_params(model, tree)        # strict: raises on any gap


def test_stage1_forward_after_import_matches_the_mirror(ref_module,
                                                        stage1_port):
    """The fused MLLM's last hidden state (LoRA active) within 1e-4."""
    vision, ids, mask = _stage1_inputs()
    with torch.no_grad():
        want = ref_module(torch.tensor(vision), torch.tensor(ids),
                          torch.tensor(mask)).numpy()
        got, _ = stage1_port(torch.tensor(vision), torch.tensor(ids),
                             torch.tensor(mask))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_stage2_forward_and_loss_after_import_match_the_mirror(
        ref_stage2, stage2_port):
    """Stage 2's prediction and denormalised MSE within 1e-4."""
    b = _stage2_batch()
    want = _ref_stage2_pred(ref_stage2, b)
    pb = _port_batch()
    with torch.no_grad():
        got = stage2_port(pb)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(
        float(denorm_mse_loss(got, pb["traj_out"], pb["norm_stat"])),
        float(denorm_mse_loss(want, pb["traj_out"], pb["norm_stat"])),
        rtol=1e-4)


def test_strip_lora_loads_into_a_llama_without_lora(ref_module, port_cfgs,
                                                     stage1_port):
    llama, qformer, _ = port_cfgs
    tree = ti.strip_lora_tree(ti.convert_reference_mllm(
        ref_module.state_dict(), qformer, llama))
    plain = load_flax_params(MultiModalLLM(
        dataclasses.replace(llama, use_lora=False), qformer), tree)
    want = {k: v for k, v in stage1_port.state_dict().items()
            if "lora" not in k}
    _assert_state_dicts_equal(plain.state_dict(), want)


def test_untied_lm_head_raises(ref_module, port_cfgs):
    sd = dict(ref_module.state_dict())
    key = next(k for k in sd if k.endswith("lm_head.weight"))
    sd[key] = sd[key] + 1.0
    with pytest.raises(ValueError, match="untied"):
        ti.convert_reference_mllm(sd, port_cfgs[1], port_cfgs[0])


# --------------------------------------------------------------------------
# flax_params and export
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage2_jax_tree(ref_stage2, stage2_cfg):
    """A stage-2 Flax tree of the JAX package (its importer's, over the
    mirror: the Flax init's leaves and shapes, its LoRA B factors with
    mass)."""
    return jax_import.convert_reference_stage2(
        ref_stage2.state_dict(), stage2_cfg, SEQ_LEN, OUT_LEN)


@pytest.mark.parametrize("part", ["mllm", "whole"])
def test_flax_params_inverts_load_flax_params(part, stage2_jax_tree,
                                              port_cfgs):
    """``flax_params(load_flax_params(m, t)) == t`` bit for bit: the MLLM
    and the whole stage-2 model (the MHAs' DenseGeneral layouts, the
    per-channel kernels, the Embedding)."""
    if part == "mllm":
        tree = stage2_jax_tree["mllm"]
        model = MultiModalLLM(port_cfgs[0], port_cfgs[1])
    else:
        tree = stage2_jax_tree
        model = TrajectoryModel(port_cfgs[2], SEQ_LEN, OUT_LEN)
    _assert_trees_equal(flax_params(load_flax_params(model, tree)), tree)


def _load_strict(module, exported):
    """The export's keys are the module's parameters (buffers keep their
    values); load it with ``strict=True``."""
    sd = module.state_dict()
    params = {n for n, _ in module.named_parameters()}
    assert set(exported) >= params, sorted(params - set(exported))
    assert set(exported) <= set(sd), sorted(set(exported) - set(sd))
    module.load_state_dict({**sd, **te.to_torch_state_dict(exported)},
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_export_equals_the_jax_package_and_loads_strict(
        stage, stage2_jax_tree, port_cfgs):
    """The same weights through both exporters: equal key for key and bit
    for bit; the port's loads ``strict=True`` into the mirror, which then
    gives the port's forward within 1e-4."""
    torch.manual_seed(0)
    if stage == "stage1":
        tree = stage2_jax_tree["mllm"]
        model = load_flax_params(MultiModalLLM(port_cfgs[0], port_cfgs[1]),
                                 tree).eval()
        got = te.export_reference_mllm(flax_params(model))
        want = jax_export.export_reference_mllm(tree)
        ref = _load_strict(RefLlamaMultiModal(), got)
        vision, ids, mask = (torch.tensor(a) for a in _stage1_inputs())
        with torch.no_grad():
            out, mine = ref(vision, ids, mask), model(vision, ids, mask)[0]
    else:
        tree = stage2_jax_tree
        model = load_flax_params(
            TrajectoryModel(port_cfgs[2], SEQ_LEN, OUT_LEN), tree).eval()
        got = te.export_reference_stage2(flax_params(model))
        want = jax_export.export_reference_stage2(tree)
        ref = _load_strict(RefMultiModalTrajectoryModel(RefLlamaMultiModal()),
                           got)
        out = _ref_stage2_pred(ref, _stage2_batch())
        with torch.no_grad():
            mine = model(_port_batch())
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(out.numpy(), mine.numpy(), **TOL)


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_import_of_export_is_bitwise(stage, stage1_port, stage2_port,
                                     port_cfgs):
    model = stage1_port if stage == "stage1" else stage2_port
    if stage == "stage1":
        sd = te.to_torch_state_dict(te.export_reference_mllm(
            flax_params(model)))
        back = _stage1_model(port_cfgs, sd)
    else:
        sd = te.to_torch_state_dict(te.export_reference_stage2(
            flax_params(model)))
        back = _stage2_model(port_cfgs, sd)
    _assert_state_dicts_equal(back.state_dict(), model.state_dict())


# --------------------------------------------------------------------------
# the commands
# --------------------------------------------------------------------------

CPU = ["--tiny", "--device", "cpu", "--preset", "test_18_18"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny ``test_18_18`` model from a seed, its port checkpoint, and
    its reference-layout files (stage 2 and the MLLM alone)."""
    from tsue_tpu_torch.cli._common import apply_overrides, base_parser
    from tsue_tpu_torch.train.checkpoint import save_state_dict
    d = tmp_path_factory.mktemp("ref_ckpt")
    cfg = apply_overrides(port_config.get_preset("test_18_18"),
                          base_parser("t").parse_args(["--tiny"]))
    model = TrajectoryModel(cfg.model, cfg.data.seq_len, cfg.data.out_len)
    init_params(model, torch.Generator().manual_seed(3))
    save_state_dict(model, str(d / "port"))
    tree = flax_params(model)
    torch.save(te.to_torch_state_dict(te.export_reference_stage2(tree)),
               d / "stage2.pt")
    torch.save(te.to_torch_state_dict(te.export_reference_mllm(tree["mllm"])),
               d / "stage1.pt")
    return cfg, model, d


def test_import_ref_then_test_and_export_ref_round_trip(tiny, capsys):
    """``import_ref --stage2`` writes what ``test --ckpt`` reads (the same
    metrics as the port's own checkpoint of the same weights), and
    ``export_ref --stage2`` of it gives the reference file back bit for
    bit."""
    import json
    from tsue_tpu_torch.runner import run_stage2
    cfg, model, d = tiny
    got = cli.main(["import_ref", "--stage2", *CPU, "--torch-ckpt",
                    str(d / "stage2.pt"), "--out", str(d / "imported")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert got["keys"] == len(torch.load(d / "stage2.pt"))
    evals = ["--k", "2", "--synthetic-tracks", "5", "--batch-size", "4"]
    metrics = cli.main(["test", *CPU, *evals, "--ckpt", str(d / "imported"),
                        "--out-dir", str(d / "eval")])
    want = run_stage2(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=4)),
        out_dir=str(d / "eval_port"), epochs=0, eval_candidates=2,
        restore_ckpt=str(d / "port"), synthetic_tracks=5, device="cpu")
    assert metrics == want and np.isfinite(metrics["test_ade"])
    cli.main(["export_ref", "--stage2", *CPU, "--ckpt", str(d / "imported"),
              "--out", str(d / "back.pt")])
    _assert_state_dicts_equal(torch.load(d / "back.pt"),
                              torch.load(d / "stage2.pt"))


def test_import_ref_stage1_feeds_train_and_round_trips(tiny):
    """Stage 1: the artifact ``train --mllm-ckpt`` reads (the MLLM's
    weights bit for bit), ``export_ref`` gives the file back, and
    ``--strip-lora`` writes a Llama without LoRA."""
    from tsue_tpu_torch.train.checkpoint import import_mllm, load_state_dict
    cfg, model, d = tiny
    cli.main(["import_ref", *CPU, "--torch-ckpt", str(d / "stage1.pt"),
              "--out", str(d / "mllm")])
    fresh = TrajectoryModel(cfg.model, cfg.data.seq_len, cfg.data.out_len)
    import_mllm(fresh, str(d / "mllm"))
    _assert_state_dicts_equal(fresh.mllm.state_dict(),
                              model.mllm.state_dict())
    cli.main(["export_ref", *CPU, "--ckpt", str(d / "mllm"), "--out",
              str(d / "mllm_back.pt")])
    _assert_state_dicts_equal(torch.load(d / "mllm_back.pt"),
                              torch.load(d / "stage1.pt"))
    cli.main(["import_ref", "--strip-lora", *CPU, "--torch-ckpt",
              str(d / "stage1.pt"), "--out", str(d / "mllm_plain")])
    m = cfg.model
    plain = MultiModalLLM(dataclasses.replace(m.llama, use_lora=False),
                          m.qformer)
    load_state_dict(plain, str(d / "mllm_plain"))
    assert not any("lora" in k for k in plain.state_dict())


def test_import_ref_raises_on_a_key_of_no_parameter(tiny):
    cfg, model, d = tiny
    sd = torch.load(d / "stage2.pt")
    sd["ltsf.unknown.weight"] = torch.zeros(1)
    torch.save(sd, d / "extra.pt")
    with pytest.raises(KeyError, match="ltsf.unknown.weight"):
        cli.main(["import_ref", "--stage2", *CPU, "--torch-ckpt",
                  str(d / "extra.pt"), "--out", str(d / "never")])
    assert not (d / "never").exists()


# --------------------------------------------------------------------------
# train/guard.py
# --------------------------------------------------------------------------

LR, WD, CLIP = 5e-4, 1e-4, 1.0
SHAPES = {"w": (8, 16), "b": (16,), "h": (4, 4)}
GUARDS = {"max_abs": MaxAbsGuardedAdamW, "clip_norm": ClipNormGuardedAdamW}


def _grad_seq(steps, big=(), bad=()):
    """Gradients from a seed; x50 at ``big`` (clipped), a NaN or an Inf
    in one tensor at ``bad`` ({step: value})."""
    rng = np.random.default_rng(11)
    seq = []
    for k in range(steps):
        g = {n: rng.normal(size=s).astype(np.float32)
             for n, s in SHAPES.items()}
        if k in big:
            g = {n: v * 50.0 for n, v in g.items()}
        if k in bad:
            g["b"][3] = bad[k]
        seq.append(g)
    return seq


def _torch_run(cls, seq):
    rng = np.random.default_rng(0)
    start = {n: rng.normal(size=s).astype(np.float32)
             for n, s in SHAPES.items()}
    params = {n: torch.nn.Parameter(torch.tensor(v))
              for n, v in start.items()}
    opt = cls(list(params.values()), LR, WD, CLIP)
    out = []
    for g in seq:
        for n, p in params.items():
            p.grad = torch.tensor(g[n])
        opt.step()
        out.append(({n: p.detach().numpy().copy()
                     for n, p in params.items()}, opt.notfinite_count))
    return start, out, opt


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_guard_is_guarded_adamw_bit_for_bit(guard):
    """Finite steps, a clipped one, a NaN and an Inf step: every
    parameter, the skip count and the state equal ``GuardedAdamW``'s bit
    for bit."""
    seq = _grad_seq(7, big=(2,), bad={4: np.nan, 5: np.inf})
    _, base, opt0 = _torch_run(trainer.GuardedAdamW, seq)
    _, mine, opt = _torch_run(GUARDS[guard], seq)
    for k, ((pa, ca), (pb, cb)) in enumerate(zip(base, mine)):
        assert ca == cb, k
        for n in SHAPES:
            np.testing.assert_array_equal(pb[n], pa[n], err_msg=f"{k} {n}")
    for n in SHAPES:           # the NaN and Inf steps moved nothing
        np.testing.assert_array_equal(mine[5][0][n], mine[3][0][n])
    s0, s1 = opt0.state_dict(), opt.state_dict()
    assert s1["notfinite_count"] == s0["notfinite_count"] == 0
    for i, st in s0["adamw"]["state"].items():
        for key, v in st.items():
            assert torch.equal(s1["adamw"]["state"][i][key], v)


def _jax_run(guard, seq):
    rng = np.random.default_rng(0)
    params = {n: jnp.asarray(rng.normal(size=s).astype(np.float32))
              for n, s in SHAPES.items()}
    adamw = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD)
    max_errors = trainer.MAX_CONSECUTIVE_ERRORS
    if guard == "max_abs":
        tx = jax_guard.apply_if_finite_fast(
            optax.chain(optax.clip_by_global_norm(CLIP), adamw), max_errors)
    else:
        tx = jax_guard.clipped_apply_if_finite(CLIP, adamw, max_errors)
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for g in seq:
        updates, state = update({n: jnp.asarray(v) for n, v in g.items()},
                                state, params)
        params = optax.apply_updates(params, updates)
        out.append(({n: np.asarray(v) for n, v in params.items()},
                    int(state.notfinite_count)))
    return out


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_guard_matches_the_jax_functions(guard):
    """The JAX package's ``apply_if_finite_fast`` / ``clipped_apply_if_
    finite`` on the same gradients (a clipped step, a NaN and an Inf
    step): the same skips and counts, parameters within the optimizer
    test's tolerance (the AdamW conventions round differently)."""
    seq = _grad_seq(7, big=(2,), bad={4: np.nan, 5: -np.inf})
    _, mine, _ = _torch_run(GUARDS[guard], seq)
    theirs = _jax_run(guard, seq)
    for k, ((pa, ca), (pb, cb)) in enumerate(zip(theirs, mine)):
        assert ca == cb, k
        for n in SHAPES:
            np.testing.assert_allclose(pb[n], pa[n], rtol=2e-5, atol=2e-6,
                                       err_msg=f"{k} {n}")


@pytest.mark.parametrize("guard", sorted(GUARDS))
def test_guard_gives_up_after_max_consecutive_errors(guard):
    """The 101st non-finite step in a row is applied, as
    ``GuardedAdamW``'s and optax's guard apply it."""
    n = trainer.MAX_CONSECUTIVE_ERRORS
    seq = _grad_seq(n + 2, bad={k: np.nan for k in range(1, n + 2)})
    _, mine, opt = _torch_run(GUARDS[guard], seq)
    assert np.isfinite(mine[n][0]["b"]).all()
    assert np.isnan(mine[n + 1][0]["b"]).all()
    assert opt.notfinite_count == n + 1


def test_max_abs_probe_propagates_nan():
    """The probe's reductions keep a NaN wherever it sits, beside larger
    values too: amax over a tensor and maximum across tensors."""
    big = torch.full((64,), 1e30)
    nan_first = torch.cat([torch.tensor([float("nan")]), big])
    assert torch.isnan(torch.amax(nan_first.abs()))
    assert torch.isnan(torch.maximum(torch.tensor(float("nan")),
                                     torch.tensor(1e30)))
    assert torch.isnan(torch.maximum(torch.tensor(1e30),
                                     torch.tensor(float("nan"))))
    opt = MaxAbsGuardedAdamW([torch.nn.Parameter(torch.zeros(2))], LR, WD)
    for grads in ([big, nan_first], [nan_first, big],
                  [big, torch.tensor([float("-inf")])]):
        assert opt._probe(grads) == (False, None)
    assert opt._probe([big, torch.zeros(0)]) == (True, None)


# --------------------------------------------------------------------------
# make_scan_epoch
# --------------------------------------------------------------------------

def test_scan_epoch_equals_the_step_loop(small_windows):
    """One epoch through ``make_scan_epoch`` over ``stack_epoch_batches``
    gives the runner's step loop's parameters and losses bit for bit,
    dropout live (each step's masks from ``state.step``)."""
    from tsue_tpu_torch.data import BatchIterator
    from tsue_tpu_torch.runner import to_device
    c = port_config
    cfg = c.ExperimentConfig(
        name="scan", data=c.DataConfig(seq_len=6, out_len=6),
        model=c.ModelConfig(use_llm=False,
                            lane=c.LaneEncoderConfig(d_model=16, nhead=2,
                                                     num_layers=1),
                            ltsf=c.LTSFConfig(d_model=16,
                                              polygon_embed_dim=16)),
        train=c.TrainConfig(batch_size=8, lr=1e-3, freeze_regime="joint"))
    it = BatchIterator(small_windows, batch_size=8, shuffle=True, seed=1)

    def fresh():
        model = TrajectoryModel(cfg.model, 6, 6)
        init_params(model, torch.Generator().manual_seed(0))
        return trainer.TrainState(model, trainer.make_optimizer(cfg, model),
                                  seed=9)

    loop = fresh()
    step = trainer.make_train_step(cfg)
    losses = torch.stack([step(loop, to_device(b, "cpu"))["loss"]
                          for b in it])
    scan, scan_losses = trainer.make_scan_epoch(cfg)(
        fresh(), trainer.stack_epoch_batches(it))
    assert loop.step == scan.step == len(scan_losses) > 1
    assert torch.equal(losses, scan_losses)
    _assert_state_dicts_equal(scan.model.state_dict(),
                              loop.model.state_dict())
