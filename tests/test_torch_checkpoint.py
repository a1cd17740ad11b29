"""Checkpoints on disk in the port: the train state for exact resume, the
best-val artifact, ``restore_merge``, ``strip_lora``, and the checkpoint
flow of ``run_stage2`` (save_every / resume, restore_ckpt, the meta.json
guard) with ``Predictor.from_checkpoint``.

The port's forms of ``tests/test_resume.py``, ``tests/test_checkpoint_viz.py``
(``TestCheckpoint``) and ``tests/test_cli_train_test_flow.py``.  The JAX
package writes Orbax trees, the port torch state dicts, so the two are not
compared here: every check is exact, within the port (``torch.equal``,
equal metric dicts).  The unit tests train a model without the LLM; the
``run_stage2`` tests a tiny frozen-MLLM model whose Llama vocabulary (500)
is resized to the byte tokenizer's (384) as ``run_stage2`` resizes it, with
dropout live everywhere.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tsue_tpu_torch.config import (DataConfig, ExperimentConfig,
                                   LaneEncoderConfig, LlamaConfig,
                                   LTSFConfig, ModelConfig, QFormerConfig,
                                   TrainConfig)
from tsue_tpu_torch.data import (BatchIterator, ByteTokenizer, build_windows,
                                 make_synthetic_tracks)
from tsue_tpu_torch.models.tsue import TrajectoryModel, init_params
from tsue_tpu_torch.runner import (evaluate, rebuild_for_eval, run_stage2,
                                   to_device)
from tsue_tpu_torch.serve import Predictor
from tsue_tpu_torch.train import checkpoint as ck
from tsue_tpu_torch.train.trainer import (TrainState, make_optimizer,
                                          make_train_step)

CFG = ExperimentConfig(
    name="resume", data=DataConfig(seq_len=6, out_len=6),
    model=ModelConfig(use_llm=False,
                      lane=LaneEncoderConfig(d_model=16, nhead=2,
                                             num_layers=1),
                      ltsf=LTSFConfig(d_model=16, polygon_embed_dim=16)),
    train=TrainConfig(batch_size=8, lr=1e-3, freeze_regime="joint"))


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def batches():
    ds = build_windows(make_synthetic_tracks(num_tracks=3, track_len=300,
                                             seed=1), CFG.data, None)
    out = [to_device(b, "cpu") for b in BatchIterator(ds, 8, shuffle=False)]
    assert len(out) >= 4
    return out[:4]


def _state(seed=0):
    model = TrajectoryModel(CFG.model, 6, 6)
    init_params(model, torch.Generator().manual_seed(seed))
    return TrainState(model, make_optimizer(CFG, model), CFG.train.seed)


def _assert_same_state(a: TrainState, b: TrainState):
    """Parameters, AdamW's moments and steps, the guard's count and the
    step, all bit for bit."""
    assert a.step == b.step
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert pa.keys() == pb.keys()
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
    sa, sb = a.optimizer.adamw.state, b.optimizer.adamw.state
    for n in pa:
        assert (pa[n] in sa) == (pb[n] in sb), n
        if pa[n] not in sa:
            continue
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[pa[n]][key], sb[pb[n]][key]), (n, key)
    assert a.optimizer.notfinite_count == b.optimizer.notfinite_count


def test_resume_exact(batches, tmp_path):
    """2 steps, save, restore into a fresh state, 2 more steps == 4 steps
    uninterrupted; ``epoch`` and ``best_val`` come back."""
    step = make_train_step(CFG)
    full = _state()
    for b in batches:
        step(full, b)

    a = _state()
    for b in batches[:2]:
        step(a, b)
    a.optimizer.notfinite_count = 3      # rides along in the same file
    path = str(tmp_path / "ts")
    ck.save_train_state(path, a, epoch=2, best_val=0.5)
    b_state, extra = ck.restore_train_state(path, _state(seed=7))
    assert extra == {"epoch": 2, "best_val": 0.5}
    assert b_state.step == 2 and b_state.optimizer.notfinite_count == 3
    _assert_same_state(a, b_state)
    b_state.optimizer.notfinite_count = 0
    for b in batches[2:]:
        step(b_state, b)
    assert full.step == b_state.step == 4
    _assert_same_state(full, b_state)


def test_subset_save_and_crash_swap_fallback(batches, tmp_path):
    """A filter stores only the trainable subset (the rest is rebuilt from
    the template at restore), and a crash in the middle of the swap leaves
    a ``.old`` survivor that ``train_state_path`` resolves."""
    keep = lambda n: "ltsf" not in n   # the forecaster counts as frozen
    step = make_train_step(CFG)
    a = _state()
    for b in batches[:2]:
        step(a, b)
    path = str(tmp_path / "ts")
    ck.save_train_state(path, a, epoch=1, best_val=0.25,
                        trainable_filter=keep)
    stored = torch.load(os.path.join(path, ck.STATE_FILE),
                        weights_only=True)["params"]
    names = set(a.model.state_dict())
    assert set(stored) == {n for n in names if keep(n)}
    assert 0 < len(stored) < len(names)

    template = _state()
    start = {n: t.clone() for n, t in template.model.state_dict().items()}
    b_state, extra = ck.restore_train_state(path, template,
                                            trainable_filter=keep)
    assert extra == {"epoch": 1, "best_val": 0.25} and b_state.step == 2
    got, want = b_state.model.state_dict(), a.model.state_dict()
    for n in names:
        assert torch.equal(got[n], want[n] if keep(n) else start[n]), n

    # a crash between the renames: the live directory moved away, only
    # `.old` remains; a second save then replaces the survivor
    os.rename(path, path + ".old")
    assert ck.train_state_path(path) == path + ".old"
    c_state, extra_c = ck.restore_train_state(path, _state(),
                                              trainable_filter=keep)
    assert extra_c == {"epoch": 1, "best_val": 0.25} and c_state.step == 2
    ck.save_train_state(path, c_state, epoch=2, trainable_filter=keep)
    assert ck.train_state_path(path) == path
    assert not os.path.exists(path + ".old")
    assert not os.path.exists(path + ".tmp")
    assert ck.train_state_path(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore_train_state(str(tmp_path / "none"), _state())


def test_best_checkpointer_protocol(tmp_path):
    """Saved only on a finite improvement; ``restore_best`` merges the
    best subset back over the model and leaves the rest alone."""
    keep = lambda n: n.startswith("ltsf.")
    bc = ck.BestCheckpointer(str(tmp_path / "best_dir"), keep)
    m1, m2, m3 = (_state(seed).model for seed in (1, 2, 3))
    assert bc.maybe_save(10.0, m1)
    assert not bc.maybe_save(11.0, m2)         # worse: not saved
    assert not bc.maybe_save(float("nan"), m2)
    assert bc.maybe_save(5.0, m2)              # better: saved
    assert bc.best_val == 5.0
    stored = torch.load(os.path.join(bc.best_path, ck.STATE_FILE),
                        weights_only=True)
    assert stored and all(keep(n) for n in stored)
    before = {n: t.clone() for n, t in m3.state_dict().items()}
    bc.restore_best(m3)
    ref = m2.state_dict()
    for n, t in m3.state_dict().items():
        assert torch.equal(t, ref[n] if keep(n) else before[n]), n


@pytest.mark.parametrize("case", ["subset", "full", "extra_key", "shape"])
def test_restore_merge(tmp_path, case):
    """A subset or a full artifact merges over the model; a key the model
    lacks, or a shape it does not have, raises naming it, before anything
    is copied."""
    src, dst = _state(1).model, _state(2).model
    state = src.state_dict()
    if case == "subset":
        state = {n: t for n, t in state.items() if n.startswith("ltsf.")}
    elif case == "extra_key":
        state["ltsf.no_such_layer.kernel"] = torch.zeros(2)
    elif case == "shape":
        state["ltsf.pos_encoding"] = torch.zeros(1, 2, 3)
    path = str(tmp_path / "art")
    os.makedirs(path)
    torch.save(state, os.path.join(path, ck.STATE_FILE))
    before = {n: t.clone() for n, t in dst.state_dict().items()}
    if case in ("extra_key", "shape"):
        name = ("ltsf.no_such_layer.kernel" if case == "extra_key"
                else "ltsf.pos_encoding")
        with pytest.raises(ValueError, match=name):
            ck.restore_merge(path, dst)
        for n, t in dst.state_dict().items():
            assert torch.equal(t, before[n]), n
        return
    assert ck.restore_merge(path, dst) is dst
    for n, t in dst.state_dict().items():
        assert torch.equal(t, state[n] if n in state else before[n]), n


def test_strip_lora():
    cfg = LlamaConfig.tiny()
    model = TrajectoryModel(ModelConfig(llama=cfg), 6, 6)
    state = model.state_dict()
    out = ck.strip_lora(state)
    assert any(".lora_a" in n for n in state)
    assert not any(n.endswith((".lora_a", ".lora_b")) for n in out)
    assert set(out) == {n for n in state
                        if not n.endswith((".lora_a", ".lora_b"))}
    no_lora = TrajectoryModel(ModelConfig(
        llama=dataclasses.replace(cfg, use_lora=False)), 6, 6)
    assert set(out) == set(no_lora.state_dict())


# --------------------------------------------------------------------------
# the checkpoint flow of run_stage2
# --------------------------------------------------------------------------

def _flow_cfg():
    """A tiny frozen-MLLM model, every dropout 0.1, its Llama vocabulary
    500 (resized to the byte tokenizer's 384 by build_model_and_params)."""
    return ExperimentConfig(
        name="ckpt_flow", data=DataConfig(seq_len=6, out_len=6,
                                          max_length=32),
        model=ModelConfig(
            llama=LlamaConfig.tiny(vocab_size=500),
            qformer=QFormerConfig(hidden_size=32, num_heads=2,
                                  num_encoder_layers=1, num_decoder_layers=1,
                                  num_query_tokens=4),
            lane=LaneEncoderConfig(d_model=16, nhead=2, num_layers=1),
            ltsf=LTSFConfig(d_model=16, polygon_embed_dim=16)),
        train=TrainConfig(batch_size=8, freeze_regime="frozen_mllm"))


RUN = dict(synthetic_tracks=5, eval_candidates=2, device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``run_stage2`` for 2 epochs with a train state every epoch."""
    cfg = _flow_cfg()
    out = str(tmp_path_factory.mktemp("flow"))
    metrics = run_stage2(cfg, out_dir=out, epochs=2, save_every=1, **RUN)
    return cfg, out, metrics


def test_run_stage2_writes_its_artifacts(trained):
    cfg, out, metrics = trained
    ckdir = os.path.join(out, cfg.name, "ckpt")
    assert set(metrics) == {"test_ade", "test_fde", "min_ade", "min_fde",
                            "min_rmse", "K"}
    with open(os.path.join(ckdir, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"name": cfg.name, "freeze_regime": "frozen_mllm",
                    "use_llm": True, "seq_len": 6, "out_len": 6,
                    "mllm_ckpt": None}
    best = torch.load(os.path.join(ckdir, "best", ck.STATE_FILE),
                      weights_only=True)
    assert best and not any(n.startswith("mllm.") for n in best)
    state = torch.load(os.path.join(ckdir, "state", ck.STATE_FILE),
                       weights_only=True)
    assert state["epoch"] == 2 and state["params"].keys() == best.keys()
    assert np.isfinite(state["best_val"])


def test_resume_equals_uninterrupted(trained, tmp_path, capsys):
    """``epochs=1, save_every=1``, then ``epochs=2, resume=True``: the test
    metrics, the best artifact and the final train state (parameters,
    AdamW's moments and steps, the guard's count) equal the uninterrupted
    run's."""
    cfg, out, metrics = trained
    run_stage2(cfg, out_dir=str(tmp_path), epochs=1, save_every=1, **RUN)
    resumed = run_stage2(cfg, out_dir=str(tmp_path), epochs=2, resume=True,
                         save_every=1, **RUN)
    assert "[resume] epoch 1, step" in capsys.readouterr().out
    assert resumed == metrics
    for what in ("best", "state"):
        a, b = (torch.load(os.path.join(d, cfg.name, "ckpt", what,
                                        ck.STATE_FILE), weights_only=True)
                for d in (out, str(tmp_path)))
        assert _same(a, b), what


def _same(x, y):
    """Equal nested artifacts, tensors bit for bit."""
    if isinstance(x, torch.Tensor):
        return isinstance(y, torch.Tensor) and torch.equal(x, y)
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(_same(x[k], y[k]) for k in x))
    if isinstance(x, (list, tuple)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(_same(a, b) for a, b in zip(x, y)))
    return x == y


def test_resume_with_nothing_to_resume_says_so(tmp_path, capsys):
    cfg = _flow_cfg()
    fresh = run_stage2(cfg, out_dir=str(tmp_path / "a"), epochs=1, **RUN)
    again = run_stage2(cfg, out_dir=str(tmp_path / "b"), epochs=1,
                       resume=True, **RUN)
    assert "[resume] nothing to resume at" in capsys.readouterr().out
    assert again == fresh


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_restore_ckpt_reproduces_the_test_metrics(trained, tmp_path, mode):
    """Training, then ``epochs=0, restore_ckpt=<best>``: the same test
    metrics exactly (the fast mode's K-candidate metrics too, whose
    generators are seeded alike)."""
    cfg, out, metrics = trained
    best = os.path.join(out, cfg.name, "ckpt", "best")
    got = run_stage2(cfg, out_dir=str(tmp_path), epochs=0,
                     restore_ckpt=best, candidate_mode=mode, **RUN)
    assert got["test_ade"] == metrics["test_ade"]
    assert got["test_fde"] == metrics["test_fde"]
    if mode == "fast":
        assert got == metrics
    assert not os.path.exists(os.path.join(str(tmp_path), cfg.name, "ckpt",
                                           "meta.json"))


def test_restore_ckpt_without_the_recorded_mllm_ckpt_raises(tmp_path):
    """A checkpoint trained with a stage-1 import, evaluated without one,
    fails before any work (the frozen MLLM would be random)."""
    ckdir = tmp_path / "ckpt"
    (ckdir / "best").mkdir(parents=True)
    (ckdir / "meta.json").write_text(json.dumps(
        {"mllm_ckpt": "/somewhere/mllm"}))
    with pytest.raises(RuntimeError, match="mllm_ckpt"):
        run_stage2(_flow_cfg(), out_dir=str(tmp_path), epochs=0,
                   restore_ckpt=str(ckdir / "best"), device="cpu")
    with pytest.raises(RuntimeError, match="mllm_ckpt"):
        Predictor.from_checkpoint(_flow_cfg(), str(ckdir / "best"),
                                  device="cpu")


def test_from_checkpoint_equals_rebuild_for_eval(trained):
    """``rebuild_for_eval``'s model has run_stage2's freeze flags and
    scores its test metrics exactly; ``Predictor.from_checkpoint`` serves,
    bit for bit, what a Predictor over that model serves."""
    cfg, out, metrics = trained
    model, (_, _, dte) = rebuild_for_eval(cfg, None, out, synthetic_tracks=5,
                                          device="cpu")
    assert model.cfg.llama.vocab_size == ByteTokenizer().vocab_size
    keep = ck.trainable_filter(model, cfg.train.freeze_regime)
    assert all(p.requires_grad == keep(n)
               for n, p in model.named_parameters())
    assert evaluate(model, dte, cfg, RUN["eval_candidates"]) == metrics
    preds = [
        Predictor.from_checkpoint(cfg, os.path.join(out, cfg.name, "ckpt",
                                                    "best"),
                                  batch_size=8, num_candidates=3,
                                  device="cpu"),
        Predictor(cfg.replace(model=model.cfg), model.state_dict(),
                  batch_size=8, num_candidates=3, device="cpu")]
    tracks = make_synthetic_tracks(num_tracks=2, track_len=300, seed=3)
    outs = [p.predict(tracks, torch.Generator().manual_seed(1))
            for p in preds]
    assert len(outs[0]) == len(outs[1]) > 0
    for a, b in zip(*outs):
        for key in ("pred_pixel_xy", "candidates_pixel_xy"):
            assert np.array_equal(a[key], b[key]), key
