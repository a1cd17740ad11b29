"""The port's plots and lane-ROI tables against the JAX package's, and the
runner's viz: ``run_stage2(viz_every=1, save_viz=True)`` writes the PNGs
the JAX package's run writes and the per-epoch text sample; the CLI's
``--viz-every``; the vendored Site-C table and the ROI loaders equal the
JAX package's; the package imports without matplotlib.
"""
import importlib
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from tsue_tpu.data import schema as jax_schema
from tsue_tpu.viz import plots as jax_plots
from tsue_tpu_torch.data import schema
from tsue_tpu_torch.viz import plots

from test_torch_checkpoint import RUN, _flow_cfg


def _jax_run_pngs(d, K):
    """The PNG names the JAX package's run_stage2(viz_every=1,
    save_viz=True) writes after one epoch: its plot calls
    (``tsue_tpu/runner.py:245-251``, ``:467-477``) made with the JAX
    plotting functions."""
    rng = np.random.default_rng(0)
    past, gt, pred = (rng.normal(size=(2, 6)) for _ in range(3))
    cands = rng.normal(size=(K, 2, 6))
    jax_plots.plot_one_sample(past, gt, pred, d, prefix="epoch0000")
    jax_plots.plot_one_sample(past, gt, pred, d, prefix="test")
    jax_plots.plot_xy_time(gt, [pred], d, prefix="test_xy_time")
    jax_plots.plot_candidates(past, gt, cands, d, prefix="test_candidates")
    jax_plots.plot_best_of_k(past, gt, cands, d, prefix="test_best_of_k")
    return sorted(os.listdir(d))


@pytest.fixture(scope="module")
def viz_run(tmp_path_factory):
    from tsue_tpu_torch.runner import run_stage2
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = _flow_cfg()
    out = tmp_path_factory.mktemp("viz")
    metrics = run_stage2(cfg, out_dir=str(out), epochs=1, viz_every=1,
                         save_viz=True, **RUN)
    yield cfg, out, metrics
    torch.set_num_threads(prev)


def test_run_stage2_writes_the_jax_runs_pngs(viz_run, tmp_path):
    cfg, out, metrics = viz_run
    got = sorted(os.listdir(out / cfg.name / "viz"))
    assert got == _jax_run_pngs(str(tmp_path), RUN["eval_candidates"])
    assert np.isfinite(metrics["min_ade"])


def test_run_stage2_writes_the_epoch_text_sample(viz_run):
    """One line an epoch, ``[epoch 0] <text>``, in
    ``generated_samples.txt`` beside the metrics (the JAX package's file);
    the text comes from the MLLM's decode with ``step_generator(777, 0)``,
    so a second call of the sample gives the same text."""
    from tsue_tpu_torch.data import get_tokenizer
    from tsue_tpu_torch.runner import (_batches, _epoch_text_sample,
                                       build_model_and_params, prepare_data,
                                       to_device)
    from tsue_tpu_torch.utils.random import step_generator
    cfg, out, _ = viz_run
    lines = (out / cfg.name / "generated_samples.txt").read_text() \
        .splitlines()
    assert len(lines) == 1 and lines[0].startswith("[epoch 0] ")
    tok = get_tokenizer()
    _, dva, _ = prepare_data(cfg, None, tok, RUN["synthetic_tracks"])
    model = build_model_and_params(cfg, tok, "cpu")
    vb = to_device(next(iter(_batches(dva, cfg, False))), "cpu")
    texts = [_epoch_text_sample(model, tok, vb, step_generator(777, 0))
             for _ in range(2)]
    assert texts[0] == texts[1] and isinstance(texts[0], str)


def test_cli_train_takes_viz_every(tmp_path, monkeypatch):
    """``--viz-every 1`` plots the epoch's validation sample and writes the
    text sample; in the same run ``--remat --remat-policy dots`` reaches
    ``LlamaConfig`` (remat on, that policy) and trains."""
    from tsue_tpu_torch.cli import train
    seen = []
    real = train.apply_overrides
    monkeypatch.setattr(train, "apply_overrides",
                        lambda cfg, args: seen.append(real(cfg, args))
                        or seen[-1])
    train.main(["--tiny", "--device", "cpu", "--preset", "test_18_18",
                "--epochs", "1", "--synthetic-tracks", "5", "--batch-size",
                "4", "--out-dir", str(tmp_path), "--viz-every", "1",
                "--remat", "--remat-policy", "dots"])
    llama = seen[0].model.llama
    assert llama.remat and llama.remat_policy == "dots"
    run = tmp_path / "test_18_18"
    assert os.listdir(run / "viz") == ["epoch0000_0.png"]
    assert (run / "generated_samples.txt").read_text().startswith(
        "[epoch 0] ")


def test_plot_functions_write_the_jax_names(tmp_path):
    """Each plot the JAX package draws, drawn by the port into a file of
    the same name."""
    rng = np.random.default_rng(1)
    past, gt, pred = (rng.normal(size=(2, 8)) * 100 for _ in range(3))
    cands = rng.normal(size=(4, 2, 8)) * 100
    roi = schema.load_vendored_lane_roi()
    calls = [("plot_one_sample", (past, gt, pred), {}),
             ("plot_candidates", (past, gt, cands), {}),
             ("plot_best_of_k", (past, gt, cands), {}),
             ("plot_xy_time", (gt, [pred, pred + 1]), {}),
             ("plot_lane_roi_map", (roi,), {}),
             ("plot_trajectories_over_map",
              ([{"past": past, "gt": gt, "pred": pred}], roi), {})]
    for name, args, kw in calls:
        ours = getattr(plots, name)(*args, str(tmp_path / "port"), **kw)
        ref = getattr(jax_plots, name)(*args, str(tmp_path / "jax"), **kw)
        assert os.path.basename(ours) == os.path.basename(ref), name
        assert os.path.getsize(ours) > 0
    with pytest.raises(ValueError, match="zone 'Z' not in ROI"):
        plots.plot_lane_roi_map(roi, str(tmp_path), zone="Z")


def test_vendored_lane_roi_is_the_jax_table():
    ours, ref = schema.load_vendored_lane_roi(), \
        jax_schema.load_vendored_lane_roi()
    assert json.dumps(ours) == json.dumps(ref)
    src = os.path.join(os.path.dirname(jax_schema.__file__),
                       "site_c_lane_roi.json")
    dst = os.path.join(os.path.dirname(schema.__file__),
                       "site_c_lane_roi.json")
    with open(src, "rb") as a, open(dst, "rb") as b:
        assert a.read() == b.read()


def test_load_lane_roi_formats_match_jax(tmp_path):
    """The .py literal (parsed, never run), .json, a pickled table and an
    all_data-style track list load as the JAX loader loads them; bad
    tables raise ValueError in both."""
    roi = jax_schema.load_vendored_lane_roi()
    paths = {"py": tmp_path / "graph.py", "json": tmp_path / "roi.json",
             "pkl": tmp_path / "roi.pkl", "tracks": tmp_path / "tracks.pkl"}
    paths["py"].write_text("import os\nlane_roi = " + repr(roi) + "\n")
    paths["json"].write_text(json.dumps(roi))
    paths["pkl"].write_bytes(pickle.dumps(roi))
    paths["tracks"].write_bytes(pickle.dumps([{"lane_roi": roi}]))
    for p in paths.values():
        assert schema.load_lane_roi(str(p)) == jax_schema.load_lane_roi(str(p))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"Site C": {"A": {"1": [[0, 0], [1, 1]]}}}))
    for loader in (schema.load_lane_roi, jax_schema.load_lane_roi):
        with pytest.raises(ValueError, match="N>=3"):
            loader(str(bad))
        with pytest.raises(ValueError, match="unsupported"):
            loader(str(tmp_path / "roi.txt"))


def test_package_imports_without_matplotlib(monkeypatch):
    """matplotlib is imported at the first plot: the package (runner, viz)
    imports where it is absent, and only plotting raises."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    fresh = importlib.reload(plots)
    importlib.import_module("tsue_tpu_torch.runner")
    with pytest.raises(ImportError):
        fresh.plot_one_sample(np.zeros((2, 3)), np.zeros((2, 3)),
                              np.zeros((2, 3)), "unused")
    monkeypatch.undo()
    importlib.reload(plots)
