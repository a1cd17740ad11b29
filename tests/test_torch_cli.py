"""The port's command-line entry points (``python -m tsue_tpu_torch.cli``),
run in process through each command's ``main(argv)`` at ``--tiny`` widths
on the CPU (``--device cpu``).

The flags map onto the same ``ExperimentConfig`` as the JAX scripts'
(``scripts/_common.py``, imported by path); ``train`` and ``test --ckpt``
give what ``run_stage2`` gives when called directly; ``stage1 --export``
writes the artifact and the generation dump; ``serve`` writes the JSONL
records of ``tests/test_serve_cli.py`` and its HTTP API, started in a
thread on port 0, answers ``/healthz``, ``/predict`` (equal to
``Predictor.predict``), ``/generate`` through both batchers, reports a
dropped track and gives 404 on an unknown path.  Flags whose work is not
ported yet raise before any work."""
import argparse
import dataclasses
import importlib.util
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu_torch import config as port_config
from tsue_tpu_torch.cli import _common, serve, stage1, test, train
from tsue_tpu_torch.runner import run_stage2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--tiny", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_common():
    spec = importlib.util.spec_from_file_location(
        "jax_scripts_common", os.path.join(REPO, "scripts", "_common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("preset,argv", [
    ("train_18_30", []),
    ("train_18_30", ["--tiny"]),
    ("test_18_18", ["--batch-size", "4", "--lr", "0.001"]),
    ("test_6_12", ["--length-buckets", "128,256", "--tiny"]),
    ("train_18_30", ["--length-buckets", "none"]),
    ("joint_24_24", ["--tiny", "--loss-chunk", "64"]),
    ("joint_24_24", ["--tiny", "--remat-policy", "dots"]),
    ("train_18_30", ["--remat"]),
    ("train_18_30", ["--pipeline-parallel", "2", "--microbatches", "8"]),
])
def test_flags_give_the_jax_scripts_config(preset, argv):
    """The same argv through the port's parser and ``apply_overrides`` and
    through the JAX scripts' gives equal configurations, field by field."""
    jc = _jax_common()

    def parsed(base):
        p = base.base_parser("t")
        p.add_argument("--pipeline-parallel", type=int, default=None)
        p.add_argument("--microbatches", type=int, default=None)
        return p.parse_args(argv)
    theirs = jc.apply_overrides(jax_config.get_preset(preset), parsed(jc))
    ours = _common.apply_overrides(port_config.get_preset(preset),
                                   parsed(_common))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _train_argv(out):
    return CPU + ["--preset", "test_18_18", "--epochs", "1",
                  "--synthetic-tracks", "5", "--batch-size", "4",
                  "--out-dir", str(out)]


def test_train_then_test_equal_run_stage2(tmp_path, capsys):
    """``train`` and ``test --ckpt`` give ``run_stage2``'s metrics for the
    same configuration, and print them as the last JSON line."""
    got = train.main(_train_argv(tmp_path / "cli"))
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    cfg = _common.apply_overrides(
        port_config.get_preset("test_18_18"),
        argparse.Namespace(batch_size=4, lr=None, tiny=True))
    ref = run_stage2(cfg, out_dir=str(tmp_path / "direct"), epochs=1,
                     synthetic_tracks=5, device="cpu")
    assert got == ref and np.isfinite(got["test_ade"])
    ckpt = str(tmp_path / "cli" / "test_18_18" / "ckpt" / "best")
    got = test.main(CPU + ["--ckpt", ckpt, "--k", "2",
                           "--synthetic-tracks", "5", "--batch-size", "4",
                           "--out-dir", str(tmp_path / "eval")])
    ref = run_stage2(cfg, out_dir=str(tmp_path / "eval_direct"), epochs=0,
                     eval_candidates=2, restore_ckpt=ckpt,
                     synthetic_tracks=5, device="cpu")
    assert got == ref and got["K"] == 2


def test_stage1_export_writes_artifact_and_dump(tmp_path):
    export = tmp_path / "mllm"
    out = stage1.main(CPU + ["--epochs", "1", "--synthetic-tracks", "6",
                             "--batch-size", "4", "--out-dir",
                             str(tmp_path), "--export", str(export)])
    assert np.isfinite(out["final_lm_loss"]) and out["generated"] > 0
    assert (export / "state.pt").exists()
    dump = tmp_path / "stage1_train_18_30" / "test_generation_results.txt"
    assert dump.read_text().count("GENERATED:") == out["generated"]


def test_serve_batch_mode_writes_jsonl(tmp_path):
    out = tmp_path / "preds.jsonl"
    meta = serve.main(CPU + ["--synthetic-tracks", "6",
                             "--serve-batch-size", "4", "--candidates", "2",
                             "--out", str(out)])
    assert meta["mode"] == "predict" and meta["results"] > 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines() if ln]
    assert len(recs) == meta["results"]
    pred = np.asarray(recs[0]["pred_pixel_xy"])
    cands = np.asarray(recs[0]["candidates_pixel_xy"])
    assert pred.shape[0] == 2 and cands.shape[:2] == (2, 2)
    assert np.isfinite(pred).all() and np.isfinite(cands).all()
    assert np.abs(pred).max() > 2.0            # pixel space, not [0, 1]


@pytest.fixture(scope="module")
def http():
    """One predictor behind two servers (static and continuous
    batcher), each serving in a thread on a free port."""
    args = serve.parser().parse_args(CPU + ["--serve-batch-size", "4",
                                            "--max-new-tokens", "8",
                                            "--port", "0"])
    cfg = _common.apply_overrides(port_config.get_preset(args.preset), args)
    pred = serve.build_predictor(args, cfg)
    servers, threads = {}, []
    for batcher in ("static", "continuous"):
        srv = serve.make_server(pred, argparse.Namespace(
            **{**vars(args), "batcher": batcher}))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        servers[batcher] = srv
        threads.append(th)
    yield pred, {k: s.server_address[1] for k, s in servers.items()}
    for srv in servers.values():
        srv.shutdown()
        srv.server_close()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()


def _call(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def _tracks(n=2, seed=3):
    from tsue_tpu_torch.data import make_synthetic_tracks
    return make_synthetic_tracks(num_tracks=n, track_len=300, seed=seed)


def _wire(tracks):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in t.items()} for t in tracks]


def test_http_healthz(http):
    pred, ports = http
    body = _call(ports["static"], "/healthz")
    assert body == {"status": "ok", "model": pred.cfg.name, "batch_size": 4,
                    "candidates": 0}


def test_http_predict_equals_predictor(http):
    pred, ports = http
    tracks = _tracks()
    body = _call(ports["static"], "/predict", {"tracks": _wire(tracks)})
    ref = pred.predict(tracks)
    assert len(body["results"]) == len(ref) > 0
    assert "dropped_track_ids" not in body
    for got, want in zip(body["results"], ref):
        assert got["track_id"] == want["track_id"]
        np.testing.assert_array_equal(np.asarray(got["pred_pixel_xy"],
                                                 np.float32),
                                      want["pred_pixel_xy"])


@pytest.mark.parametrize("batcher", ["static", "continuous"])
def test_http_generate(http, batcher):
    """/generate through each batcher: one text record per track, the
    request's cap clamped to the server's (8)."""
    pred, ports = http
    body = _call(ports[batcher], "/generate",
                 {"tracks": _wire(_tracks()), "max_new_tokens": 50})
    assert [r["track_id"] for r in body["results"]] == [0, 1]
    assert all(isinstance(r["context"], str) for r in body["results"])
    ids = pred.last_request["ids"]
    if batcher == "static":
        assert ids.shape == (2, 8)
    else:                           # rows end at EOS or at the cap
        assert all(len(row) <= 8 for row in ids)
        assert pred.last_request["pool"]["ticks"] <= 8


def test_http_reports_dropped_track(http):
    """A track whose windows are all filtered out (too short) comes back
    in ``dropped_track_ids``, beside the served one."""
    _, ports = http
    short = dict(_tracks(1)[0], track_id=7)
    short["raw_trajectory"] = short["raw_trajectory"][:10]
    short["vision_embeddings"] = short["vision_embeddings"][:10]
    body = _call(ports["static"], "/predict",
                 {"tracks": _wire(_tracks(1) + [short])})
    assert {r["track_id"] for r in body["results"]} == {0}
    assert body["dropped_track_ids"] == [7]


@pytest.mark.parametrize("method", ["GET", "POST", "POST_32MB"])
def test_http_unknown_path_is_404(http, method):
    """A 404 whose JSON body the client reads in full, also after a POST
    body the server does not need (the server reads it before it replies
    and closes, so the close sends no reset)."""
    _, ports = http
    payload = {"GET": None, "POST": {}, "POST_32MB": {"pad": "x" * (1 << 25)}}
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(ports["static"], "/nope", payload[method])
    assert e.value.code == 404
    assert json.loads(e.value.read()) == {"error": "unknown path /nope"}


@pytest.mark.parametrize("command,argv,error", [
    ("stage1", ["--pipeline-parallel", "2"], NotImplementedError),
    ("serve", ["--model-parallel", "2"], NotImplementedError),
    ("serve", ["--fsdp"], NotImplementedError),
    ("serve", ["--batcher", "continuous", "--fused-head"], ValueError),
    ("train", ["--rng-impl", "rbg"], SystemExit),
])
def test_flags_not_taken_raise_before_any_work(tmp_path, command, argv,
                                               error):
    """A flag whose work is not ported yet raises NotImplementedError
    naming its ROADMAP item, the continuous batcher with the fused head a
    ValueError, and a JAX-only flag is unknown to the parser; each before
    any work (no output, and the default CUDA device is never asked
    for)."""
    mod = {"train": train, "test": test, "stage1": stage1,
           "serve": serve}[command]
    with pytest.raises(error) as e:
        mod.main(argv + ["--out-dir", str(tmp_path / "out")])
    if error is NotImplementedError:
        assert "ROADMAP A:" in str(e.value)
    assert not (tmp_path / "out").exists()


def test_module_dispatches_to_the_commands(capsys):
    """``python -m tsue_tpu_torch.cli <command>`` runs that command's
    ``main`` with the rest of the argv; anything else is a usage error."""
    from tsue_tpu_torch.cli import COMMANDS
    from tsue_tpu_torch.cli.__main__ import main
    assert COMMANDS == ("train", "stage1", "test", "serve", "baseline",
                        "diffusion")
    with pytest.raises(SystemExit, match="usage"):
        main(["predict"])
    with pytest.raises(SystemExit, match="usage"):
        main([])
    with pytest.raises(NotImplementedError, match="--fsdp"):
        main(["serve", "--fsdp"])
    assert main(["serve"] + CPU + ["--synthetic-tracks", "1",
                                   "--serve-batch-size", "2"])["results"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["mode"] == \
        "predict"
