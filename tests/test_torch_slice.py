"""The serving slice as a whole: ``Predictor.predict`` in the port against
the JAX package's, at a tiny configuration.

Flax initialises the TrajectoryModel, ``load_flax_params`` carries the
weights, and both predictors serve the same synthetic tracks through the
shared windowing.  Pixel tolerance 1e-2 px: the outputs are pixel
coordinates up to ~4000 px, fp32 keeps ~7 digits, and the two stacks sum in
different orders through the whole model.  Torch cannot reproduce JAX's
dropout masks, so candidates are compared with every dropout rate at 0 (all
K then equal the deterministic forecast); with dropout live the port is
checked for diverse, reproducible candidates.
"""
import jax
import numpy as np
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
from tsue_tpu.serve import Predictor as JaxPredictor
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.data import build_windows, make_synthetic_tracks
from tsue_tpu_torch.data.tokenizer import ByteTokenizer
from tsue_tpu_torch.models.tsue import TrajectoryModel
from tsue_tpu_torch.serve import Predictor

K = 3
PX_TOL = dict(atol=1e-2, rtol=0)


def _cfg(dropout: float, c=port_config):
    """The slice's configuration in the config classes of module ``c`` (the
    port's by default, the JAX package's for its predictor)."""
    tok = ByteTokenizer()
    return c.ExperimentConfig(
        name="torch_slice",
        data=c.DataConfig(seq_len=6, out_len=6, max_length=32),
        model=c.ModelConfig(
            llama=c.LlamaConfig.tiny(tok.vocab_size),
            qformer=c.QFormerConfig(hidden_size=32, num_heads=2,
                                    num_encoder_layers=1,
                                    num_decoder_layers=1,
                                    num_query_tokens=4, dropout=dropout),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1,
                                     dropout=dropout),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16,
                              dropout=dropout)))


@pytest.fixture(scope="module")
def stacks():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg0 = _cfg(0.0, jax_config)
    model = JaxTrajectoryModel(cfg0.model, 6, 6)
    dummy = JaxPredictor(cfg0, None, batch_size=4)._dummy_batch()
    params = jax.device_get(jax.jit(
        lambda b: model.init({"params": jax.random.key(0),
                              "dropout": jax.random.key(1)}, b, False))(
        dummy)["params"])
    jax_pred = JaxPredictor(cfg0, params, batch_size=4, num_candidates=K,
                            tokenizer=JaxByteTokenizer())
    state = load_flax_params(TrajectoryModel(_cfg(0.0).model, 6, 6),
                             params).state_dict()

    def port(dropout):
        return Predictor(_cfg(dropout), state, batch_size=4,
                         num_candidates=K, tokenizer=ByteTokenizer(),
                         device="cpu").warmup()

    yield jax_pred, port(0.0), port(0.1)
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tracks():
    return make_synthetic_tracks(num_tracks=2, track_len=300, seed=11)


def test_predict_matches_jax(stacks, tracks):
    jax_pred, port0, _ = stacks
    ref = jax_pred.predict(tracks)
    out = port0.predict(tracks)
    assert len(out) == len(ref) > 4        # more than one chunk
    for r, o in zip(ref, out):
        assert o["track_id"] == r["track_id"]
        for key in ("past_pixel_xy", "pred_pixel_xy", "candidates_pixel_xy"):
            assert o[key].shape == np.shape(r[key])
            np.testing.assert_allclose(o[key], np.asarray(r[key]), **PX_TOL)
        assert o["candidates_pixel_xy"].shape == (K, 2, 6)


def test_live_dropout_candidates_diverse_and_reproducible(stacks, tracks):
    _, port0, port_live = stacks
    out = port_live.predict(tracks, torch.Generator().manual_seed(5))
    again = port_live.predict(tracks, torch.Generator().manual_seed(5))
    other = port_live.predict(tracks, torch.Generator().manual_seed(6))
    det = port0.predict(tracks)
    for o, a, x, d in zip(out, again, other, det):
        c = o["candidates_pixel_xy"]
        assert np.all(np.isfinite(c))
        assert not np.allclose(c[0], c[1])              # K candidates differ
        np.testing.assert_array_equal(c, a["candidates_pixel_xy"])
        assert not np.array_equal(c, x["candidates_pixel_xy"])
        # the deterministic forward ignores the forecaster's dropout
        np.testing.assert_array_equal(o["pred_pixel_xy"], d["pred_pixel_xy"])


def test_empty_input(stacks):
    assert stacks[1].predict([]) == []


def test_tail_batch_padding(stacks):
    """A window count that batch_size does not divide returns every row,
    and the padded repeats of the last window do not leak into it."""
    port = stacks[1]
    tracks = make_synthetic_tracks(num_tracks=3, track_len=300, seed=8)
    n = len(build_windows(tracks, port.cfg.data, port.tokenizer))
    assert n % port.batch_size
    out = port.predict(tracks)
    assert len(out) == n
    last = port.predict(tracks[-1:])
    np.testing.assert_allclose(out[-1]["pred_pixel_xy"],
                               last[-1]["pred_pixel_xy"], atol=1e-4)


def test_metrics_match_jax():
    """ade_fde and min_ade_fde_rmse (with the reference's /2T RMSE) on the
    same normalized candidates, with and without a validity mask."""
    import jax.numpy as jnp
    from tsue_tpu.eval import metrics as jm
    from tsue_tpu_torch.eval import metrics as tm
    rng = np.random.default_rng(9)
    cands = rng.random((5, 4, 2, 6), dtype=np.float32)
    target = rng.random((5, 2, 6), dtype=np.float32)
    lo = rng.random((5, 1), dtype=np.float32) * 100
    stat = np.concatenate([lo, lo + 300, lo, lo + 50], axis=1)
    valid = np.array([1, 1, 0, 1, 0], np.int32)
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else torch.from_numpy(v)
        ref = (jm.ade_fde(jnp.asarray(cands[:, 0]), jnp.asarray(target),
                          jnp.asarray(stat), jv)
               + jm.min_ade_fde_rmse(jnp.asarray(cands), jnp.asarray(target),
                                     jnp.asarray(stat), jv))
        out = (tm.ade_fde(torch.from_numpy(cands[:, 0]),
                          torch.from_numpy(target), torch.from_numpy(stat), tv)
               + tm.min_ade_fde_rmse(torch.from_numpy(cands),
                                     torch.from_numpy(target),
                                     torch.from_numpy(stat), tv))
        np.testing.assert_allclose([float(o) for o in out],
                                   [float(r) for r in ref], rtol=1e-5)
