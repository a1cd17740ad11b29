"""The port's two trained-weight studies (``tsue_tpu_torch.cli.
study_speculative_acceptance`` and ``study_fast_vs_parity``) against the
JAX package's scripts, at ``--tiny`` widths on the CPU (``--device cpu``).

- The mid-size configuration and the flags with their defaults equal the
  JAX scripts' (``scripts/study_*.py``, loaded by path).
- Speculative study: the port trains the tiny byte MLLM with stage 1 for
  one epoch; ``convert.flax_params`` carries the trained MLLM into the JAX
  ``MultiModalLLM``, whose ``make_generate_fn`` and
  ``make_speculative_generate_fn(with_stats=True)`` on the study's
  ``prompt_only`` batch give the port's ids and per-row forward counts
  exactly, with the ``none`` and the ``hf`` processors; the study's
  ``tok_per_fwd`` and ``token_agreement``, and its emitted count, equal
  the JAX script's formulas (``:127-137``) on the JAX outputs.
- Parity study: ``study.json`` has the JAX layout; its ``raw`` rows equal
  ``runner.evaluate`` of the rebuilt model at seeds 5000 and 5977 bit for
  bit; the rebuilt artifact, carried into the JAX ``TrajectoryModel``,
  gives the JAX ``evaluate``'s deterministic ADE and FDE within relative
  1e-4 (fp32, sums in other orders).
- ``python -m tsue_tpu_torch.cli study_speculative_acceptance`` prints the
  JAX script's keys.
"""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tsue_tpu import config as jax_config
from tsue_tpu.data.windowing import WindowedDataset as JaxWindowedDataset
from tsue_tpu.eval.generation import make_generate_fn as jax_generate_fn
from tsue_tpu.eval.speculative import \
    make_speculative_generate_fn as jax_speculative_fn
from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
from tsue_tpu.ops.sampling import SamplingConfig as JaxSamplingConfig
from tsue_tpu.parallel.mesh import make_mesh
from tsue_tpu.runner import evaluate as jax_evaluate
from tsue_tpu_torch.cli import _common
from tsue_tpu_torch.cli import study_fast_vs_parity as fvp
from tsue_tpu_torch.cli import study_speculative_acceptance as sa
from tsue_tpu_torch.cli.__main__ import main as cli_main
from tsue_tpu_torch.convert import flax_params
from tsue_tpu_torch.data import get_tokenizer
from tsue_tpu_torch.eval.generation import make_generate_fn
from tsue_tpu_torch.eval.speculative import make_speculative_generate_fn
from tsue_tpu_torch.runner import evaluate, rebuild_for_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--tiny", "--device", "cpu"]
SPEC_ARGV = CPU + ["--epochs", "1", "--synthetic-tracks", "2", "--bs", "4",
                   "--max-new", "16", "--reps", "1"]
FVP_ARGV = CPU + ["--epochs", "1", "--seeds", "2", "--k", "2",
                  "--synthetic-tracks", "5"]
REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_script(name):
    """``scripts/<name>.py`` as a module (its ``_common`` import resolved
    from ``scripts/``)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    return mod


class _Parsed(Exception):
    pass


def _jax_parser(mod):
    """The parser the JAX script's ``main`` builds (caught at its
    ``parse_args``)."""
    base = mod.base_parser

    def catching(desc):
        p = base(desc)

        def stop(*a, **kw):
            raise _Parsed(p)
        p.parse_args = stop
        return p
    mod.base_parser = catching
    try:
        mod.main()
    except _Parsed as caught:
        return caught.args[0]
    raise AssertionError("the JAX script parsed no arguments")


def _defaults(p):
    return {a.dest: (a.default, a.choices) for a in p._actions
            if a.dest not in ("help", "platform", "rng_impl", "device")}


def _jax_cfg(obj):
    """A port config dataclass as the JAX package's class of its name."""
    if not dataclasses.is_dataclass(obj):
        return obj
    return getattr(jax_config, type(obj).__name__)(**{
        f.name: _jax_cfg(getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("script,port", [
    ("study_fast_vs_parity", fvp), ("study_speculative_acceptance", sa)])
def test_config_and_flags_match_the_jax_scripts(script, port):
    """``midsize_cfg`` is the JAX script's configuration, field for field
    (the two differ only in name and regime), and the command takes the
    script's flags with their defaults and choices (``--device`` in place
    of ``--platform``; no ``--rng-impl``)."""
    mod = _jax_script(script)
    theirs = mod.midsize_cfg()
    ours = _common.midsize_cfg(theirs.name, theirs.train.freeze_regime)
    assert dataclasses.asdict(_jax_cfg(ours)) == dataclasses.asdict(theirs)
    assert _defaults(port.parser()) == _defaults(_jax_parser(mod))


def test_emitted_counts_through_the_first_eos():
    rows = np.array([[5, 7, 2, 2], [5, 2, 9, 2], [5, 6, 7, 8]])
    np.testing.assert_array_equal(_common.emitted(rows, 2), [3, 2, 4])


# --------------------------------------------------------------------------
# speculative acceptance
# --------------------------------------------------------------------------

def _run_quiet(fn, *a, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        result = fn(*a, **kw)
    return result, out.getvalue()


def _jax_script_keys(script):
    """The keys of the dict the JAX script prints with ``json.dumps``."""
    tree = ast.parse(open(os.path.join(REPO, "scripts",
                                       f"{script}.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  "") == "dumps":
            if isinstance(node.args[0], ast.Dict):
                return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps of a dict in {script}")


@pytest.fixture(scope="module")
def spec_study(tmp_path_factory):
    """``python -m tsue_tpu_torch.cli study_speculative_acceptance`` at
    tiny width (no processors), run in this process as ``python -m`` runs
    it (``cli.__main__.main``): its JSON line, its trained MLLM read back
    from the export, the study's prompts, and the JAX MLLM with the
    trained parameters carried into it."""
    out = tmp_path_factory.mktemp("spec")
    _, printed = _run_quiet(cli_main, ["study_speculative_acceptance",
                                       *SPEC_ARGV, "--out-dir", str(out)])
    args = sa.parser().parse_args(SPEC_ARGV)
    cfg = _common.apply_overrides(_common.midsize_cfg("study_spec_accept"),
                                  args)
    tok = get_tokenizer(None)
    mllm = sa.load_mllm(cfg, tok, str(out / "spec_accept_mllm"), "cpu")
    jm = JaxMLLM(_jax_cfg(mllm.llama.cfg), _jax_cfg(mllm.qformer.cfg),
                 use_vision=mllm.use_vision)
    return dict(printed=printed, mllm=mllm, tok=tok, jm=jm,
                jv={"params": flax_params(mllm)},
                inputs=sa.study_inputs(cfg, None, tok, args.synthetic_tracks,
                                       args.split, args.bs))


def _jax_outputs(study, processors, max_new=16, window=8):
    """The JAX script's plain and speculative decodes (``:108-120``) of the
    study's prompts, on the port's trained MLLM."""
    tok = study["tok"]
    greedy = (JaxSamplingConfig(do_sample=False) if processors == "hf"
              else JaxSamplingConfig(do_sample=False, repetition_penalty=1.0,
                                     no_repeat_ngram_size=0))
    P = study["inputs"][1].shape[1]
    plain = jax_generate_fn(study["jm"], greedy, max_new, P,
                            eos_id=tok.eos_id, pad_id=tok.pad_id)
    spec = jax_speculative_fn(study["jm"], greedy, max_new, P,
                              eos_id=tok.eos_id, pad_id=tok.pad_id,
                              window=window, draft_ngram=3, with_stats=True)
    av = [jnp.asarray(a) for a in study["inputs"]]
    key = jax.random.key(0)
    ref = np.asarray(plain(study["jv"], *av, key))
    got, n_fwd = spec(study["jv"], *av, key)
    return ref, np.asarray(got), np.asarray(n_fwd)


def _port_outputs(study, processors, max_new=16, window=8):
    """The study's plain and speculative decodes in the port."""
    tok = study["tok"]
    greedy = sa.greedy_config(processors)
    inputs = [torch.from_numpy(a) for a in study["inputs"]]
    P = inputs[1].shape[1]
    plain = make_generate_fn(study["mllm"], greedy, max_new, P, tok.eos_id,
                             tok.pad_id)
    spec = make_speculative_generate_fn(study["mllm"], greedy, max_new, P,
                                        tok.eos_id, tok.pad_id,
                                        window=window, with_stats=True)
    got, n_fwd = spec(*inputs, None)
    return plain(*inputs, None).numpy(), got.numpy(), n_fwd.numpy()


@pytest.mark.parametrize("processors", ["none", "hf"])
def test_speculative_study_matches_jax(spec_study, processors):
    """The JAX package's plain and speculative greedy decodes of the
    study's prompts, on the port's trained weights, give the port's ids
    and per-row forward counts exactly; the emitted count is the JAX
    script's, and with no processors (the study's run) its printed
    ``tok_per_fwd`` and ``token_agreement`` are the JAX script's formulas
    (``:127-137``) on the JAX outputs."""
    tok = spec_study["tok"]
    ref, got, n_fwd = _jax_outputs(spec_study, processors)
    ours = _port_outputs(spec_study, processors)
    np.testing.assert_array_equal(ours[0], ref)
    np.testing.assert_array_equal(ours[1], got)
    np.testing.assert_array_equal(ours[2], n_fwd)
    tot = 0
    for r in got:
        e = np.nonzero(r == tok.eos_id)[0]
        tot += (int(e[0]) + 1) if e.size else len(r)
    rows = _common.emitted(ours[1], tok.eos_id)
    assert int(rows.sum()) == tot
    assert (n_fwd <= rows).all() and (n_fwd >= -(-rows // 8)).all()
    if processors == "none":
        res = json.loads(spec_study["printed"].splitlines()[-1])
        assert res["tok_per_fwd"] == round(tot / float(n_fwd.sum()), 2)
        assert res["token_agreement"] == round(float((got == ref).mean()),
                                               4)


def test_module_prints_the_jax_scripts_keys(spec_study):
    """``python -m tsue_tpu_torch.cli study_speculative_acceptance`` ends
    in one JSON line with the JAX script's keys (``:151-158``), in its
    order, and the values of the run's flags."""
    res = json.loads(spec_study["printed"].splitlines()[-1])
    assert list(res) == _jax_script_keys("study_speculative_acceptance")
    assert (res["window"], res["epochs"], res["split"]) == (8, 1, "train")
    assert all(np.isfinite(res[k]) and res[k] > 0 for k in (
        "plain_tok_s", "spec_tok_s", "speedup", "final_lm_loss"))
    assert spec_study["inputs"][1].shape == (4, 640)


# --------------------------------------------------------------------------
# fast against parity
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def parity_study(tmp_path_factory):
    out = tmp_path_factory.mktemp("fvp")
    result, printed = _run_quiet(fvp.main, FVP_ARGV + ["--out-dir",
                                                       str(out)])
    return dict(result=result, printed=printed, out=str(out))


def test_parity_study_writes_the_jax_layout(parity_study):
    """``study.json`` holds the JAX script's keys (``:82-103``), each
    summary entry numpy's mean and population std over the raw rows, and
    is the printed JSON line."""
    cfg = _common.midsize_cfg("study_fast_vs_parity", "joint")
    path = os.path.join(parity_study["out"], cfg.name, "study.json")
    with open(path) as f:
        study = json.load(f)
    assert study == parity_study["result"]
    assert json.loads(parity_study["printed"].splitlines()[-1]) == study
    assert (study["k"], study["seeds"], study["epochs"]) == (2, 2, 1)
    assert list(study) == ["k", "seeds", "epochs", "summary", "raw"]
    assert list(study["summary"]) == ["minADE", "minFDE", "minRMSE"]
    for j, name in enumerate(("minADE", "minFDE", "minRMSE")):
        f = np.array([r[j] for r in study["raw"]["fast"]])
        q = np.array([r[j] for r in study["raw"]["parity"]])
        assert study["summary"][name] == {
            "fast_mean": float(f.mean()), "fast_std": float(f.std()),
            "parity_mean": float(q.mean()), "parity_std": float(q.std()),
            "delta_pct": float(100.0 * (f.mean() - q.mean()) / q.mean())}
    assert "| minADE |" in parity_study["printed"]


@pytest.fixture(scope="module")
def rebuilt(parity_study):
    cfg = _common.apply_overrides(
        _common.midsize_cfg("study_fast_vs_parity", "joint"),
        fvp.parser().parse_args(FVP_ARGV))
    model, splits = rebuild_for_eval(cfg, None, parity_study["out"],
                                     synthetic_tracks=5, device="cpu")
    return cfg, model, splits[2]


def test_parity_study_rows_equal_evaluate(parity_study, rebuilt):
    """Each raw row is ``runner.evaluate`` of the rebuilt model at eval
    seed 5000 + 977 s, bit for bit."""
    cfg, model, dte = rebuilt
    for mode in ("fast", "parity"):
        for s, seed in enumerate((5000, 5977)):
            m = evaluate(model, dte, cfg, eval_candidates=2,
                         candidate_mode=mode, eval_seed=seed)
            assert parity_study["result"]["raw"][mode][s] == \
                [m["min_ade"], m["min_fde"], m["min_rmse"]], (mode, s)


def test_rebuilt_artifact_matches_the_jax_evaluate(rebuilt):
    """The rebuilt artifact in the JAX ``TrajectoryModel``: the JAX
    ``evaluate``'s deterministic ADE and FDE (no candidates) equal the
    port's within relative 1e-4."""
    cfg, model, dte = rebuilt
    jcfg = _jax_cfg(dataclasses.replace(cfg, model=model.cfg))
    jmodel = JaxTrajectoryModel(jcfg.model, cfg.data.seq_len,
                                cfg.data.out_len)
    jdte = JaxWindowedDataset(**{f.name: getattr(dte, f.name)
                                 for f in dataclasses.fields(dte)})
    mesh = make_mesh(1)
    with mesh:
        ref = jax_evaluate(jmodel, flax_params(model), jdte, jcfg, mesh, 0)
    ours = evaluate(model, dte, cfg)
    assert set(ours) == set(ref) == {"test_ade", "test_fde"}
    for key in ("test_ade", "test_fde"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=REL, atol=0)
