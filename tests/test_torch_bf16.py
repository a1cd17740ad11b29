"""bfloat16 parameters in the port against the JAX package, on the CPU.

Both packages start from one Flax init of the train-parity model of
``tests/test_torch_train.py`` under a "bfloat16" ``ModelConfig``, cast as
each package's runner casts it (``utils.precision.cast_params``); every
dropout is 0.  Checked: the forward and the MLLM's hidden states against
JAX's ``apply``; one train step in three freeze regimes (the loss, the
updated parameters, AdamW's moments against optax's, every dtype), and
one AdamW step of the port on the JAX package's gradients; the kernels'
plain versions in bf16 against the Pallas kernels in interpret mode;
LoRA above rank 16; the repairs (a bf16 checkpoint served, a resumed bf16
run; stage 1 of a bf16 configuration is in ``test_torch_remat.py``).

Tolerances, measured on this host and stated in bf16 ulps (2^-8 relative
at the top of a binade, 2^-7 at its bottom):

- loss: 1.4e-4 relative (the bar is 1e-2); asserted within 1e-3;
- forward: the prediction within 5e-3 of its largest value (measured
  3.6e-3, about one ulp of it), the MLLM's bf16 hidden states within 4
  ulps of their largest (measured 3.4: the two packages round the residual
  stream at different points);
- the updated parameters.  Adam's first step moves an element by about
  lr (5e-4); 72-84% of the elements move.  An element's value may differ
  from optax's by one ulp of the value and three of the step, ulp(lr):
  optax rounds the moments' ratio and the step to bf16, torch rounds m /
  sqrt(v) to bf16 and adds the step to the value in one rounding
  (measured within one ulp of the value and two of the step).  On the
  port's own gradients that holds, and the port moves the same way as
  optax, wherever optax moved the value and the JAX gradient is above
  12% of its tensor's largest (the moments' noise, below); 1.8-2.7% of
  the elements differ, asserted under 4%.  A skipped, doubled or reversed
  step is off by lr, 128 ulps of the step.  On the JAX package's
  gradients it holds everywhere, no element moves the other way, 0.01-
  0.05% of the elements move in one package only (the step lands on a
  rounding boundary; asserted under 0.2%), and 1.6-2.4% differ (asserted
  under 3%);
- the moments, bf16 (AdamW's first is 0.1 times the clipped gradient, its
  second 1e-3 times its square).  On the port's own gradients: within 12%
  and 25% of the tensor's largest (measured 10.9% and 12.6%: a bf16
  backward's relu masks flip where the pre-activation rounds across 0,
  and the square doubles the relative error), the attention key biases
  aside, whose gradients are 0 in exact arithmetic and rounding noise in
  both packages.  On the JAX package's gradients: within two ulps of each
  element (measured one: the clip's factor rounds in each package, then
  the moment).

Both packages run with the fused switch on (the JAX kernels in interpret
mode, the port's Functions over their plain versions).

The optax reference is the train branch of the JAX package's optimizer,
``clip_by_global_norm`` then ``adamw`` (``tsue_tpu/train/trainer.py:87-91``),
over the regime's trainable parameters: its non-finite guard passes a
finite step through unchanged, and its frozen branch leaves the other
parameters as they are.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
from tsue_tpu.ops.fused import fused_scope as jax_fused_scope
from tsue_tpu.train import trainer as jax_trainer
from tsue_tpu.train.losses import denorm_mse_loss as jax_loss
from tsue_tpu.utils.precision import cast_params as jax_cast
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import _convert_leaf, _flatten, load_flax_params
from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                 make_synthetic_tracks)
from tsue_tpu_torch.data.tokenizer import ByteTokenizer
from tsue_tpu_torch.models.tsue import TrajectoryModel
from tsue_tpu_torch.ops import fused
from tsue_tpu_torch.ops.flash import flash_attention, flash_attention_plain
from tsue_tpu_torch.ops.fused import fused_scope
from tsue_tpu_torch.ops.lora import lora_matmul_plan, lora_ref
from tsue_tpu_torch.train import trainer
from tsue_tpu_torch.utils.precision import cast_params

from test_torch_train import LR, _cfg, _port_named

BF = torch.bfloat16
ULP = 2.0 ** -8


def _ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _bf16(c, regime="joint"):
    cfg = _cfg(c, regime)
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 dtype="bfloat16"))


REGIMES = ("frozen_mllm", "lora_only", "joint")


def _optax_steps(jparams, grads):
    """optax's train branch, ``clip_by_global_norm`` then ``adamw``, in
    each regime over its trainable parameters: {regime: (gradients, updated
    parameters, mu, nu)}, each {Flax path: array}.  The leaves go end to
    end into one vector a regime (the clip's norm and AdamW's elementwise
    update are the tree's; the program is small to compile)."""
    leaves = dict(_flatten_tree(jparams))
    gleaves = dict(_flatten_tree(grads))
    keys = {r: [k for k in leaves
                if jax_trainer.freeze_label(k, r) == "train"]
            for r in REGIMES}
    vecs = {r: tuple(jnp.concatenate([jnp.ravel(t[k]) for k in ks])
                     for t in (leaves, gleaves))
            for r, ks in keys.items()}

    def run(v):
        out = {}
        for r, (pv, gv) in v.items():
            jcfg = _bf16(jax_config, r).train
            tx = optax.chain(
                optax.clip_by_global_norm(jcfg.grad_clip),
                optax.adamw(jcfg.lr, weight_decay=jcfg.weight_decay))
            upd, st = tx.update(gv, tx.init(pv), pv)
            out[r] = (optax.apply_updates(pv, upd),
                      optax.tree_utils.tree_get(st, "mu"),
                      optax.tree_utils.tree_get(st, "nu"))
        return out
    out = jax.device_get(jax.jit(run)(vecs))
    steps = {}
    for r, ks in keys.items():
        sizes = np.cumsum([leaves[k].size for k in ks])[:-1]
        split = [dict(zip(ks, (a.reshape(leaves[k].shape)
                               for a, k in zip(np.split(v, sizes), ks))))
                 for v in out[r]]
        steps[r] = ({k: gleaves[k] for k in ks},) + tuple(split)
    return steps


@pytest.fixture(scope="module")
def setup():
    """The batch, the Flax init (fp32, as the runner builds it before the
    cast), the cast parameters, the loss and its gradients, the
    prediction and the MLLM's hidden states (one compiled program), and
    optax's step in each regime."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = _bf16(port_config)
    ds = build_windows(make_synthetic_tracks(num_tracks=3, track_len=300,
                                             seed=1), cfg.data,
                       ByteTokenizer())
    b = next(iter(BatchIterator(ds, 4, shuffle=True, seed=42)))
    b = dict(b, polygon=b["polygon"] / 1000.0)
    jmodel = JaxTrajectoryModel(_bf16(jax_config).model, 6, 6)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    params = jax.device_get(jax.jit(lambda b_: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b_,
        False))(jb)["params"])
    jparams = jax_cast(params)

    def run(p, b_):
        def loss_fn(p_):
            pred = jmodel.apply({"params": p_}, b_, True)
            return jax_loss(pred, b_["traj_out"], b_["norm_stat"],
                            b_["valid"]), pred
        (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        hidden = jmodel.apply({"params": p}, b_, method=lambda m, x: m.mllm(
            x["vision"], x["input_ids"], x["attention_mask"]))[0]
        return loss, grads, pred, hidden
    with jax_fused_scope("on"):
        loss, grads, pred, hidden = jax.device_get(jax.jit(run)(jparams,
                                                                jb))
    port = cast_params(load_flax_params(TrajectoryModel(cfg.model, 6, 6),
                                        params))
    yield dict(jparams=jparams, loss=float(loss), pred=pred, hidden=hidden,
               steps=_optax_steps(jparams, grads),
               tb={k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
               start={k: v.clone() for k, v in port.state_dict().items()})
    torch.set_num_threads(prev)


def _port(setup, cfg=None):
    model = TrajectoryModel((cfg or _bf16(port_config)).model, 6, 6)
    cast_params(model)
    model.load_state_dict(setup["start"])
    return model


def test_cast_params_gives_the_jax_dtypes(setup):
    """Every parameter bf16 on both sides after the cast; integer and
    boolean tensors of a state dict untouched."""
    model = _port(setup)
    jdt = {path: np.asarray(v).dtype
           for path, v in _flatten(setup["jparams"]).items()}
    assert set(jdt.values()) == {np.dtype(jnp.bfloat16)}
    assert {p.dtype for p in model.parameters()} == {BF}
    assert len(jdt) == len(list(model.parameters()))
    sd = cast_params({"w": torch.ones(2), "i": torch.arange(2),
                      "m": torch.ones(2, dtype=torch.bool)})
    assert [sd[k].dtype for k in "wim"] == [BF, torch.int64, torch.bool]


def test_forward_and_hidden_states_match_jax(setup):
    model = _port(setup)
    tb = setup["tb"]
    with torch.no_grad(), fused_scope("on"):
        pred = model(tb)
        hidden, _ = model.mllm(tb["vision"], tb["input_ids"],
                               tb["attention_mask"])
    ref_pred, ref_hidden = setup["pred"], setup["hidden"]
    assert pred.dtype == torch.float32 and ref_pred.dtype == np.float32
    assert hidden.dtype == BF and ref_hidden.dtype == jnp.bfloat16
    np.testing.assert_allclose(pred.numpy(), ref_pred, rtol=0,
                               atol=5e-3 * np.abs(ref_pred).max())
    ref_hidden = np.asarray(ref_hidden, np.float32)
    np.testing.assert_allclose(hidden.float().numpy(), ref_hidden, rtol=0,
                               atol=4 * ULP * np.abs(ref_hidden).max())


def _noise(name):
    """The attention key biases: their gradients are 0 in exact
    arithmetic (softmax does not see a constant added to every key) and
    rounding noise in both packages."""
    mod, leaf = name.rsplit(".", 1)
    return leaf == "bias" and mod.endswith(".k")


def _against_optax(model, regime, setup, opt, own):
    """Hold the port's updated parameters and moments against optax's
    step in ``regime``; ``own``: the port stepped on its own gradients
    (else on the JAX package's).  Returns the share of trainable elements
    whose value differs from optax's."""
    gflat, new, mu, nu = setup["steps"][regime]
    named = {".".join(k): v for k, v in new.items()}
    grads = {".".join(k): v for k, v in gflat.items()}
    modules = dict(model.named_modules())
    labels = trainer.param_labels(model, regime)
    start = setup["start"]
    n_trainable = n_elements = n_differ = n_moved_apart = 0
    for name, p in model.named_parameters():
        assert p.dtype == BF, name
        if labels[name] == "freeze":
            assert torch.equal(p.detach(), start[name]), name
            continue
        n_trainable += 1
        mod, leaf = name.rsplit(".", 1)
        key = _flax_key(modules[mod], mod, leaf, named)
        assert named[key].dtype == jnp.bfloat16
        ref = _to_port(modules[mod], key, named[key])
        g = _to_port(modules[mod], key, grads[key])
        s = start[name].float().numpy()
        out = p.detach().float().numpy()
        n_elements += out.size
        n_differ += int((out != ref).sum())
        n_moved_apart += int(((out != s) != (ref != s)).sum())
        # one ulp of the value and three of the step (the module's
        # docstring)
        tol = _ulp(np.maximum(np.abs(out), np.abs(ref))) + 3 * _ulp(LR)
        if own:
            # where optax moved the value and the gradient is above the
            # packages' rounding noise, the port moved it the same way and
            # by the same amount
            sel = (ref != s) & (np.abs(g) > 0.12 * np.abs(g).max())
            if _noise(name):
                sel[...] = False
            assert (np.sign(out - s) == np.sign(ref - s))[sel].all(), name
        else:
            # on the same gradients: never the other way, and by the same
            # amount everywhere (one side may stay where the other moves
            # by a rounding boundary: counted below)
            sel = np.ones(out.shape, bool)
            assert (np.sign(out - s) * np.sign(ref - s) >= 0).all(), name
        assert (np.abs(out - ref) <= tol)[sel].all(), name
        adam = opt.adamw.state[p]
        for moment, tree, rel in (("exp_avg", mu, 0.12),
                                  ("exp_avg_sq", nu, 0.25)):
            m = adam[moment]
            r = {".".join(k): v for k, v in tree.items()}[key]
            assert m.dtype == BF and r.dtype == jnp.bfloat16, (name, moment)
            r = _to_port(modules[mod], key, r)
            m = m.float().numpy()
            if not own:
                # the clip's factor rounds in each package, then the moment
                bad = np.abs(m - r) > 2 * _ulp(np.maximum(np.abs(m),
                                                          np.abs(r)))
                assert not bad.any(), (name, moment)
            elif not _noise(name):
                np.testing.assert_allclose(
                    m, r, rtol=0, atol=rel * np.abs(r).max() + 1e-30,
                    err_msg=f"{name} {moment}")
    assert n_trainable == len(new)
    if not own:
        # on the same gradients the two round a step differently only near
        # a rounding boundary
        assert n_moved_apart <= 2e-3 * n_elements
    return n_differ / n_elements


@pytest.mark.parametrize("regime", REGIMES)
def test_train_step_matches_optax(setup, regime):
    """One step on the port's own gradients: the loss, then every updated
    parameter and moment against optax's.  Then one AdamW step of the
    port on the JAX package's gradients, which isolates the optimizer's
    arithmetic from the two backwards."""
    cfg = _bf16(port_config, regime)
    model = _port(setup, cfg)
    with fused_scope("on"):
        state = trainer.TrainState(model, trainer.make_optimizer(cfg, model),
                                   cfg.train.seed)
        loss = float(trainer.make_train_step(cfg)(state, setup["tb"])
                     ["loss"])
    np.testing.assert_allclose(loss, setup["loss"], rtol=1e-3)
    assert _against_optax(model, regime, setup, state.optimizer,
                          own=True) < 0.04

    model = _port(setup, cfg)
    opt = trainer.make_optimizer(cfg, model)
    params = dict(model.named_parameters())
    gflat = setup["steps"][regime][0]
    tree = {}
    for path, g in gflat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.asarray(g, np.float32)
    for name, (g, _) in _port_named(model, tree).items():
        params[name].grad = torch.from_numpy(np.ascontiguousarray(g)).to(BF)
    opt.step()
    assert _against_optax(model, regime, setup, opt, own=False) < 0.03


def _flatten_tree(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten_tree(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _flax_key(module, mod, leaf, named):
    """The Flax path (dotted) of a port parameter."""
    flax_leaf = {"weight": ("kernel", "scale", "embedding")}.get(leaf,
                                                                  (leaf,))
    for fl in flax_leaf:
        if f"{mod}.{fl}" in named:
            return f"{mod}.{fl}"
    raise KeyError(f"{mod}.{leaf}")


def _to_port(module, key, value):
    _, arr = _convert_leaf(module, key.rsplit(".", 1)[1],
                           np.asarray(value).astype(np.float32), key)
    return arr


# --------------------------------------------------------------------------
# the kernels' plain versions in bf16 against the Pallas kernels
# --------------------------------------------------------------------------

COMBOS = {"f32": (np.float32, np.float32), "bf16": (BF, BF),
          "bf16_q": (BF, np.float32), "f32_q": (np.float32, BF)}


def _t(a, dtype):
    t = torch.from_numpy(a)
    return t.to(dtype) if isinstance(dtype, torch.dtype) else t


def _j(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype is BF else jnp.float32)


def _flash_inputs(combo, rope, shape="causal"):
    """Causal GQA 4/2 x 64 over a padded key mask (a row with no valid key
    included): (q, k, v, mask, rope tables or None) in numpy fp32.  A
    decode shape, "decode_tq1" or "decode_tq4": Tq queries of GQA 4/1 x 64
    over a 70-slot cache, 55 slots valid in one row and none in the
    other.  "ltsf_cross": the LTSF cross-attention's layout (2 heads of
    1024, G 1), 6 queries over 70 keys, 41 valid in one row and none in
    the other."""
    if shape == "ltsf_cross":
        rng = np.random.default_rng(9)
        B, Tq, Tk, H, D = 2, 6, 70, 2, 1024
        q = rng.normal(size=(B, Tq, H, D)).astype(np.float32)
        k, v = (rng.normal(size=(B, Tk, H, D)).astype(np.float32)
                for _ in range(2))
        mask = (np.arange(Tk)[None] < np.array([[41], [0]])).astype(np.int32)
        return q, k, v, mask, None
    if shape != "causal":
        rng = np.random.default_rng(6)
        B, Tq, Tk, Hq, Hkv, D = 2, int(shape[-1]), 70, 4, 1, 64
        q = rng.normal(size=(B, Tq, Hq, D)).astype(np.float32)
        k, v = (rng.normal(size=(B, Tk, Hkv, D)).astype(np.float32)
                for _ in range(2))
        mask = (np.arange(Tk)[None] < np.array([[55], [0]])).astype(np.int32)
        return q, k, v, mask, None
    rng = np.random.default_rng(5)
    B, T, Hq, Hkv, D = 2, 12, 4, 2, 64
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
            for _ in range(2))
    mask = (np.arange(T)[None] < np.array([[9], [0]])).astype(np.int32)
    ang = rng.uniform(0, 20, (B, T, D // 2)).astype(np.float32)
    return q, k, v, mask, (np.cos(ang), np.sin(ang)) if rope else None


def _rmsnorm_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(160, 256)).astype(np.float32) * 3
    return x, (1 + 0.1 * rng.normal(size=256)).astype(np.float32)


def _swiglu_inputs():
    rng = np.random.default_rng(8)
    g = rng.normal(size=(160, 256)).astype(np.float32) * 3
    g[:, :16] = np.linspace(-30, 30, 16)
    u = rng.normal(size=(160, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 128)) / 16).astype(np.float32)
    return g, u, w


def _lora_inputs(r):
    rng = np.random.default_rng(r)
    x = rng.normal(size=(40, 96)).astype(np.float32)
    w, a, b = (rng.normal(size=s).astype(np.float32) * 0.05
               for s in ((96, 136), (96, r), (r, 136)))
    return x, w, a, b


# (combo, rope, shape): the causal shape in every combination, the decode
# step's shapes in bf16 (the card's "bf16_decode" form), and the LTSF
# cross-attention's with bf16 k and v (the card's "bf16_wide" form)
FLASH_CASES = ([(c, r, "causal") for r in (False, True) for c in COMBOS]
               + [("bf16", False, "decode_tq1"), ("bf16", False, "decode_tq4")]
               + [(c, False, "ltsf_cross") for c in ("f32_q", "bf16")])
RMS_CASES = ("bf16_bf16", "bf16_f32", "f32_bf16")
LORA_CASES = [(r, d) for r in (24, 64) for d in (np.float32, BF)]


def _dtypes(spec):
    return tuple(BF if t == "bf16" else np.float32 for t in spec.split("_"))


@pytest.fixture(scope="module")
def pallas():
    """Every case's Pallas kernel in interpret mode, compiled as one
    program: {(kernel, case): output as numpy fp32, its dtype}."""
    from tsue_tpu.ops.flash import flash_attention as jax_flash
    from tsue_tpu.ops.fused import fused_rmsnorm as jax_rmsnorm
    from tsue_tpu.ops.fused import swiglu_matmul as jax_swiglu
    from tsue_tpu.ops.lora import lora_matmul as jax_lora
    args = {}
    for combo, rope, shape in FLASH_CASES:
        qd, kd = COMBOS[combo]
        q, k, v, mask, cs = _flash_inputs(combo, rope, shape)
        args[f"flash {combo} {rope} {shape}"] = (
            _j(q, qd), _j(k, kd), _j(v, kd), jnp.asarray(mask),
            None if cs is None else tuple(map(jnp.asarray, cs)))
    x, sc = _rmsnorm_inputs()
    for spec in RMS_CASES:
        xd, sd = _dtypes(spec)
        args[f"rmsnorm {spec}"] = (_j(x, xd), _j(sc, sd))
    args["swiglu"] = tuple(_j(a, BF) for a in _swiglu_inputs())
    for r, dtype in LORA_CASES:
        args[f"lora {r} {dtype is BF}"] = tuple(_j(t, dtype)
                                                for t in _lora_inputs(r))

    def run(a):
        out = {}
        for key, val in a.items():
            kind, *case = key.split(" ")
            if kind == "flash":
                q, k, v, mask, cs = val
                out[key] = jax_flash(q, k, v, mask, case[2] == "causal",
                                     None, cs, interpret=True)
            elif kind == "rmsnorm":
                out[key] = jax_rmsnorm(*val, 1e-5, interpret=True)
            elif kind == "swiglu":
                out[key] = jax_swiglu(*val, interpret=True)
            else:
                out[key] = jax_lora(*val, 32.0 / int(case[0]), True)
        return out
    out = jax.device_get(jax.jit(run)(args))
    return {k: (np.asarray(v, np.float32), str(v.dtype))
            for k, v in out.items()}


@pytest.mark.parametrize(
    "combo, rope, shape", FLASH_CASES,
    ids=[f"{c}-{r}" if s == "causal" else f"{c}-{s}"
         for c, r, s in FLASH_CASES])
def test_flash_plain_matches_pallas_in_each_dtype(pallas, combo, rope,
                                                  shape):
    """(q, k/v) in fp32, bf16 and both mixes, with and without the rope,
    causal over a padded key mask (a row with no valid key included), GQA
    4/2 x 64; bf16 decode steps (Tq 1 and 4, GQA 4/1 x 64, a 70-slot key
    mask with padded slots and a row with no valid key); the LTSF
    cross-attention's layout (2 heads of 1024, 6 queries over 70 keys, a
    padded row and a row with no valid key) with fp32 and bf16 q over bf16
    k and v: the output in
    q's dtype, within one bf16 ulp of the interpreted Pallas kernel (2^-8
    relative, 2^-8 of the largest output absolute: a probability or output
    rounded on the other side), or 1e-5 where every operand is fp32."""
    qd, kd = COMBOS[combo]
    q, k, v, mask, cs = _flash_inputs(combo, rope, shape)
    ref, ref_dtype = pallas[f"flash {combo} {rope} {shape}"]
    args = (_t(q, qd), _t(k, kd), _t(v, kd), torch.from_numpy(mask),
            shape == "causal", None,
            None if cs is None else tuple(map(torch.from_numpy, cs)))
    out = flash_attention_plain(*args)
    assert out.dtype == args[0].dtype
    assert ref_dtype == str(args[0].dtype).replace("torch.", "")
    assert torch.equal(out, flash_attention(*args))     # the CPU path
    tol = (dict(rtol=1e-5, atol=1e-5) if combo == "f32" else
           dict(rtol=ULP, atol=ULP * np.abs(ref).max()))
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)


@pytest.mark.parametrize("dtypes", RMS_CASES)
def test_rmsnorm_plain_matches_pallas_in_bf16(pallas, dtypes):
    """bf16 x and/or scale: fp32 sums, x's dtype out, within one bf16 ulp
    (2^-8 relative) of the interpreted kernel; the Function on the CPU
    takes the same plain version."""
    xd, sd = _dtypes(dtypes)
    x, s = _rmsnorm_inputs()
    ref, _ = pallas[f"rmsnorm {dtypes}"]
    out = fused.fused_rmsnorm(_t(x, xd), _t(s, sd), 1e-5)
    assert out.dtype == (BF if xd is BF else torch.float32)
    assert torch.equal(out, fused.rmsnorm_plain(_t(x, xd), _t(s, sd), 1e-5))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=ULP, atol=1e-6)


def test_swiglu_plain_matches_pallas_in_bf16(pallas):
    """bf16 gate, up and W (M 160, K 256, N 128, the gate up to +-30):
    silu in fp32 rounded to bf16, times up in bf16, fp32 sums, bf16 out,
    within one ulp of the largest output (2^-8) of the interpreted
    kernel."""
    ref, _ = pallas["swiglu"]
    args = [_t(a, BF) for a in _swiglu_inputs()]
    out = fused.swiglu_matmul(*args)
    assert out.dtype == BF
    assert torch.equal(out, fused.swiglu_matmul_plain(*args))
    big = np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=ULP,
                               atol=ULP * big)


@pytest.mark.parametrize("r", [24, 64])
def test_lora_plain_above_rank_16_matches_pallas(pallas, r):
    """The LoRA plain version at ranks past 16 (the SIMT form's rank
    walks on the card) against the interpreted kernel, which takes any
    rank: fp32 within 1e-5, bf16 (xA rounded to bf16) within one ulp of the
    largest output; the plan names the SIMT form in both dtypes."""
    for dtype in (np.float32, BF):
        ref, _ = pallas[f"lora {r} {dtype is BF}"]
        out = lora_ref(*(_t(t, dtype) for t in _lora_inputs(r)), 32.0 / r,
                       round_xa=True)
        big = np.abs(ref).max()
        tol = (dict(rtol=1e-5, atol=1e-5 * big) if dtype is np.float32
               else dict(rtol=ULP, atol=ULP * big))
        np.testing.assert_allclose(out.float().numpy(), ref, **tol)
        tdt = torch.float32 if dtype is np.float32 else BF
        assert lora_matmul_plan(40, 96, 136, r, tdt)["form"] == "simt"
        assert lora_matmul_plan(8448, 2048, 2048, r, tdt)["form"] == "simt"


# --------------------------------------------------------------------------
# the repairs: a bf16 checkpoint served, stage 1 in fp32, resume in bf16
# --------------------------------------------------------------------------

def _flow_bf16():
    from test_torch_checkpoint import _flow_cfg
    cfg = _flow_cfg()
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 dtype="bfloat16"))


def _merged_fp32(cfg, best):
    """(configuration, state): the model ``build_model_and_params`` builds
    for ``cfg`` in fp32, the artifact ``best`` merged into it, under
    ``cfg``'s dtype and the tokenizer's vocabulary."""
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.runner import build_model_and_params
    from tsue_tpu_torch.train.checkpoint import restore_merge
    fp32 = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    model = build_model_and_params(fp32, get_tokenizer(), "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    restore_merge(best, model)
    return (cfg.replace(model=dataclasses.replace(model.cfg,
                                                  dtype=cfg.model.dtype)),
            model.state_dict())


def test_bf16_run_is_served_from_its_checkpoint(tmp_path):
    """``run_stage2`` trains a bf16 configuration (bf16 parameters and
    moments, a bf16 best artifact), and ``Predictor.from_checkpoint`` of it
    serves fp32 parameters, as the JAX package restores into its fp32 init,
    and predicts what ``Predictor(cfg, state)`` predicts over the same
    merged state in fp32: the model built in fp32 with the artifact
    merged, under the "bfloat16" configuration."""
    from test_torch_checkpoint import RUN
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.runner import build_model_and_params, run_stage2
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train.checkpoint import _read
    cfg = _flow_bf16()
    metrics = run_stage2(cfg, out_dir=str(tmp_path), epochs=1, **RUN)
    assert np.isfinite(metrics["test_ade"])
    best = str(tmp_path / cfg.name / "ckpt" / "best")
    stored = _read(best)
    assert stored and {v.dtype for v in stored.values()} == {BF}
    # training builds in bf16; serving the artifact keeps fp32
    assert {p.dtype for p in build_model_and_params(
        cfg, get_tokenizer(), "cpu").parameters()} == {BF}
    served = Predictor.from_checkpoint(cfg, best, device="cpu",
                                       batch_size=4, num_candidates=2)
    assert {p.dtype for p in served.model.parameters()} == {torch.float32}
    direct_cfg, state = _merged_fp32(cfg, best)
    assert served.model.cfg == direct_cfg.model
    assert all(torch.equal(v, state[k])
               for k, v in served.model.state_dict().items())
    direct = Predictor(direct_cfg, state, device="cpu", batch_size=4,
                       num_candidates=2)
    tracks = make_synthetic_tracks(num_tracks=2, track_len=300, seed=3)
    a, b = served.predict(tracks), direct.predict(tracks)
    assert a and len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and x["track_id"] == y["track_id"]
        for key in ("pred_pixel_xy", "candidates_pixel_xy"):
            np.testing.assert_array_equal(x[key], y[key])


def _serve_cfg(c):
    """``test_18_18`` at tiny widths under a "bfloat16" ``ModelConfig``,
    in the config classes of module ``c``."""
    base = c.get_preset("test_18_18")
    return base.replace(
        name="bf16_serve",
        data=dataclasses.replace(base.data, max_length=32,
                                 length_buckets=()),
        model=c.ModelConfig(
            llama=c.LlamaConfig.tiny(ByteTokenizer().vocab_size),
            qformer=c.QFormerConfig(hidden_size=32, num_heads=2,
                                    num_encoder_layers=1,
                                    num_decoder_layers=1,
                                    num_query_tokens=4),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16),
            dtype="bfloat16"))


def test_from_checkpoint_serves_fp32_parameters_as_the_jax_package(tmp_path):
    """``Predictor.from_checkpoint`` of a "bfloat16" configuration in both
    packages, over one artifact of bf16 values that holds every parameter
    (so neither package's initialisation enters), each written as a bf16
    run writes it, by its package's own writer: both serve fp32 parameters
    (the configuration rounds the Llama's weights per call, activations
    stay fp32) and predict the same windows within 1e-3 px, four fp32 ulps
    at the largest coordinate (3708 px): the two stacks sum in different
    orders (measured 4.9e-4 to 5.5e-4 px; bf16 parameters, as the port
    served them before, put the first window 0.79 px off)."""
    from tsue_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
    from tsue_tpu.serve import Predictor as JaxPredictor
    from tsue_tpu.train.checkpoint import save_pytree
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train.checkpoint import save_state_dict
    jcfg, pcfg = _serve_cfg(jax_config), _serve_cfg(port_config)
    T, F = pcfg.data.seq_len, pcfg.data.out_len
    dummy = JaxPredictor(jcfg, None, batch_size=4)._dummy_batch()
    model = JaxTrajectoryModel(jcfg.model, T, F)
    params = jax.device_get(jax.jit(lambda b: model.init(
        {"params": jax.random.key(5), "dropout": jax.random.key(6)}, b,
        False))(dummy)["params"])
    bf = jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16), params)
    save_pytree(str(tmp_path / "jax"), bf)
    port_model = load_flax_params(
        TrajectoryModel(pcfg.model, T, F),
        jax.tree.map(lambda a: np.asarray(a, np.float32), bf))
    save_state_dict(cast_params(port_model), str(tmp_path / "port"))
    theirs = JaxPredictor.from_checkpoint(
        jcfg, str(tmp_path / "jax"), dummy, batch_size=4,
        tokenizer=JaxByteTokenizer())
    ours = Predictor.from_checkpoint(pcfg, str(tmp_path / "port"),
                                     device="cpu", batch_size=4,
                                     tokenizer=ByteTokenizer())
    tracks = make_synthetic_tracks(num_tracks=2, track_len=300, seed=11)
    ref, out = theirs.predict(tracks), ours.predict(tracks)
    assert len(out) == len(ref) > 0
    for r, o in zip(ref, out):
        assert o["track_id"] == r["track_id"]
        np.testing.assert_allclose(o["pred_pixel_xy"],
                                   np.asarray(r["pred_pixel_xy"]),
                                   atol=1e-3, rtol=0)
    assert {np.asarray(a).dtype for a in jax.tree.leaves(theirs.params)} \
        == {np.dtype(np.float32)}
    assert {p.dtype for p in ours.model.parameters()} == {torch.float32}


def test_resumed_bf16_run_equals_the_uninterrupted_one(tmp_path):
    """Train state of bf16 parameters (bf16 leaves and moments on disk):
    a run interrupted after epoch 1 and resumed to 2 equals the
    uninterrupted 2-epoch run, metrics and best artifact."""
    from test_torch_checkpoint import RUN
    from tsue_tpu_torch.runner import run_stage2
    from tsue_tpu_torch.train.checkpoint import _read
    cfg = _flow_bf16()
    full = run_stage2(cfg, out_dir=str(tmp_path / "a"), epochs=2, **RUN)
    run_stage2(cfg, out_dir=str(tmp_path / "b"), epochs=1, save_every=1,
               **RUN)
    state = _read(str(tmp_path / "b" / cfg.name / "ckpt" / "state"))
    assert {v.dtype for v in state["params"].values()} == {BF}
    moments = [s["exp_avg"] for s in
               state["optimizer"]["adamw"]["state"].values()]
    assert moments and {m.dtype for m in moments} == {BF}
    resumed = run_stage2(cfg, out_dir=str(tmp_path / "b"), epochs=2,
                         resume=True, **RUN)
    assert resumed == full
    a, b = (_read(str(tmp_path / d / cfg.name / "ckpt" / "best"))
            for d in "ab")
    assert all(torch.equal(a[k], b[k]) for k in a)
