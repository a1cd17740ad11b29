"""The port's diagnostics against the JAX package's, on the CPU:
``utils.debug.count_params`` of the tiny configuration's TrajectoryModel
(built on the ``meta`` device, as the ``params`` command builds it) equal to
the JAX package's ``count_params`` of the same configuration's Flax tree in
every freeze regime (total, trainable and per group); ``apply_top_k``
equal to the JAX package's; ``checked`` raising on a non-finite output and
naming it; ``nan_probe`` printing and returning its input; ``profile_trace``
writing a Chrome trace, and nothing for ``None``."""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
from tsue_tpu.ops.sampling import apply_top_k as jax_apply_top_k
from tsue_tpu.train.trainer import freeze_label as jax_freeze_label
from tsue_tpu.utils.debug import count_params as jax_count_params
from tsue_tpu_torch.cli import params as params_cli
from tsue_tpu_torch.cli._common import apply_overrides, base_parser
from tsue_tpu_torch.ops.sampling import NEG_INF, apply_top_k
from tsue_tpu_torch.utils.checks import checked
from tsue_tpu_torch.utils.debug import count_params, debug_print, nan_probe
from tsue_tpu_torch.utils.logging import profile_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(c):
    """Preset train_18_30 with the ``--tiny`` widths, in config module c."""
    cfg = c.get_preset("train_18_30")
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, llama=c.LlamaConfig.tiny(),
        qformer=c.QFormerConfig(num_encoder_layers=1, num_decoder_layers=1,
                                num_query_tokens=4),
        lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
        ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16)),
        data=dataclasses.replace(cfg.data, max_length=640))


@pytest.fixture(scope="module")
def jax_tree():
    sys.path.insert(0, REPO)
    from __graft_entry__ import _make_batch
    cfg = _tiny(jax_config)
    model = JaxTrajectoryModel(cfg.model, cfg.data.seq_len,
                               cfg.data.out_len)
    shapes = jax.eval_shape(
        lambda b: model.init({"params": jax.random.key(0),
                              "dropout": jax.random.key(1)}, b, False),
        _make_batch(cfg, 2))
    return shapes["params"]


@pytest.mark.parametrize("regime", params_cli.REGIMES)
def test_count_params_equals_jax(jax_tree, regime):
    port_cfg = apply_overrides(
        __import__("tsue_tpu_torch.config", fromlist=["x"]).get_preset(
            "train_18_30"), base_parser("x").parse_args(["--tiny"]))
    ours = params_cli.count_model_params(port_cfg, regime)
    theirs = jax_count_params(jax_tree,
                              lambda s: jax_freeze_label(s, regime))
    assert ours == theirs
    assert 0 < ours["trainable"] <= ours["total"]


def test_count_params_of_a_state_dict():
    sd = {"a.w": torch.zeros(3, 4), "a.b": torch.zeros(4),
          "c.w": torch.zeros(5)}
    out = count_params(sd, lambda s: "freeze" if s[0] == "a" else "train")
    assert out == {"total": 21, "trainable": 5,
                   "groups": {"a": 16, "c": 5}}


@pytest.mark.parametrize("k", [0, 1, 5, 16, 40])
def test_apply_top_k_equals_jax(k):
    rng = np.random.default_rng(k)
    logits = rng.standard_normal((3, 40)).astype(np.float32)
    logits[1, :8] = 2.0                      # a tie at the k-th value
    ours = apply_top_k(torch.from_numpy(logits), k).numpy()
    theirs = np.asarray(jax_apply_top_k(jnp.asarray(logits), k))
    np.testing.assert_array_equal(ours, theirs)
    if 0 < k < 40:
        assert ((ours > NEG_INF).sum(-1) >= k).all()


def test_checked_raises_on_a_nan_and_names_it():
    def step(x):
        return {"loss": x.sum(), "aux": [x, torch.log(x)]}

    good = checked(step)(torch.ones(3))
    assert float(good["loss"]) == 3.0
    with pytest.raises(FloatingPointError, match=r"out\['aux'\]\[1\]"):
        checked(step)(torch.tensor([1.0, -1.0]))
    assert checked(lambda: torch.arange(3))().tolist() == [0, 1, 2]


def test_nan_probe_prints_and_returns_its_input(capsys):
    x = torch.tensor([1.0, 2.0])
    assert nan_probe(x, "ok") is x and capsys.readouterr().out == ""
    y = torch.tensor([1.0, float("nan")])
    assert nan_probe(y, "fused") is y
    assert "[nan_probe] fused: NON-FINITE" in capsys.readouterr().out
    debug_print("printed", 3)
    assert capsys.readouterr().out == "printed 3\n"


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "t" / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    with profile_trace(None):
        pass
    assert os.listdir(tmp_path) == ["t"]
