"""The port's parallel layer (``tsue_tpu_torch/parallel``) against the JAX
package's, on the CPU over gloo.

- The rule table: every parameter of a small TrajectoryModel and every
  int8 table resolves to the spec that the JAX package's ``_resolve``
  gives the same Flax path, on TP, FSDP, TP+FSDP and a model degree that
  does not divide (replication); ``shard_state`` cuts and re-joins.
- One launch of two ranks (this file run as a script, with torchrun's
  environment; a rank that outlives ``TIMEOUT_S`` is killed and the test
  fails) runs every multi-process case, each checked here against the
  port in one process and the JAX package on two devices of its CPU mesh:
  TP 2 greedy generation (the decode switches off and all three on), pure
  DP 2 generation row for row, the DP 2, DP 2 + FSDP and TP 2 stage-2
  steps, FSDP at a threshold of 0, ``Predictor.predict`` under TP 2, the
  HTTP API under a mesh (a malformed body; last, a request that fails on
  rank 1 alone, which exits 1), the continuous batcher's mesh pool,
  ``distributed_generate_and_save`` and a checkpoint written by two ranks
  restored in one.
- The CLI under ``torch.distributed.run``.

The model is ``tests/test_torch_train.py``'s train-parity TrajectoryModel
(a 2-layer Llama 128 wide with 4/2 heads: 2/1 a rank at TP 2), every
dropout at 0: a DP step then equals the one-process step.  The steps run
clip + SGD (the guard and the clip over the global gradient, then an
update affine in it: Adam's first step would turn reduction-order noise on
near-zero gradients into sign flips), as ``tests/test_multichip.py`` does,
at a learning rate of 1: the clipped update is then large beside one fp32
ulp of the parameters it moves.
"""
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tsue_tpu import config as jax_config  # noqa: E402
from tsue_tpu_torch import config as port_config  # noqa: E402
from tsue_tpu_torch.data import (BatchIterator, build_windows,  # noqa: E402
                                 make_synthetic_tracks)
from tsue_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from tsue_tpu_torch.parallel import mesh as M  # noqa: E402
from tsue_tpu_torch.parallel import sharding as S  # noqa: E402

TIMEOUT_S = 180
MAX_NEW = 6
B = 4
SGD_LR = 1.0
FSDP_MIN = 1024
FLAGS = {"off": {}, "all": dict(quantize_decode=True, quantize_kv=True,
                                fused_head=True)}


def _cfg(c, regime="joint"):
    """The train-parity configuration (``test_torch_train._cfg``)."""
    return c.ExperimentConfig(
        name="torch_parallel",
        data=c.DataConfig(seq_len=6, out_len=6, max_length=32,
                          length_buckets=()),
        model=c.ModelConfig(
            llama=c.LlamaConfig(
                vocab_size=ByteTokenizer().vocab_size, hidden_size=128,
                intermediate_size=256, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=32, rope_scaling_factor=1.0,
                lora_dropout=0.0),
            qformer=c.QFormerConfig(hidden_size=32, num_heads=2,
                                    num_encoder_layers=1,
                                    num_decoder_layers=1,
                                    num_query_tokens=4, dropout=0.0),
            lane=c.LaneEncoderConfig(d_model=16, nhead=2, num_layers=1,
                                     dropout=0.0),
            ltsf=c.LTSFConfig(d_model=16, polygon_embed_dim=16,
                              dropout=0.0)),
        train=c.TrainConfig(batch_size=B, freeze_regime=regime))


def _batches(n=1):
    cfg = _cfg(port_config)
    ds = build_windows(make_synthetic_tracks(num_tracks=3, track_len=300,
                                             seed=1), cfg.data,
                       ByteTokenizer())
    it = BatchIterator(ds, B, shuffle=True, seed=42)
    return [dict(b, polygon=b["polygon"] / 1000.0) for _, b in zip(range(n),
                                                                     it)]


def _tracks():
    return make_synthetic_tracks(num_tracks=2, track_len=300,
                                 vision_dim=512, seed=3)


def _gen_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, 6, 512)).astype(np.float32),
            rng.integers(3, 380, (B, 16)).astype(np.int32),
            np.ones((B, 16), np.int32))


def _port_model(state):
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    model = TrajectoryModel(_cfg(port_config).model, 6, 6)
    model.load_state_dict(state)
    return model


def _sgd_step(state, batch):
    """One train step with the guarded clip and SGD in place of AdamW."""
    from tsue_tpu_torch.train import trainer
    state.optimizer.adamw = torch.optim.SGD(state.optimizer.params,
                                            lr=SGD_LR, foreach=False)
    m = trainer.make_train_step(_cfg(port_config))(state, batch)
    return float(m["loss"])


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The two ranks (this file as a script)
# ---------------------------------------------------------------------------

def _worker(d: str) -> None:
    from tsue_tpu_torch.eval.generation import distributed_generate_and_save
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.parallel.serve_tp import make_sharded_generate_fn
    from tsue_tpu_torch.runner import _place_for_training, run_stage2
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.data.text_dataset import build_track_text_dataset
    torch.set_num_threads(1)
    assert M.initialize_distributed("gloo")
    rank = torch.distributed.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    state = inp["state"]
    cfg = _cfg(port_config)
    tp = M.make_mesh(2, device="cpu")
    dp = M.make_mesh(1, device="cpu")
    out = {"mesh": (tp.data, tp.model, tp.model_rank, dp.data, dp.data_rank)}
    greedy = SamplingConfig(do_sample=False)
    vision, ids, mask = (torch.from_numpy(a) for a in inp["gen"])

    def gen(mesh, **kw):
        g, local = make_sharded_generate_fn(
            _port_model(state).mllm, greedy, MAX_NEW, ids.shape[1], 383,
            mesh, **kw)
        return g(vision, ids, mask, torch.Generator().manual_seed(0)), local

    for name, kw in FLAGS.items():
        out[f"tp_ids_{name}"], local = gen(tp, **kw)
    out["tp_q_shape"] = tuple(
        local.llama.model.layer_0.attn.q_proj.kernel.shape)
    out["dp_ids"], _ = gen(dp)
    out["dp_fsdp_ids"], _ = gen(dp, fsdp=True, fsdp_min_size=FSDP_MIN)
    # a threshold of 0: every parameter with a dim the data axis divides
    out["dp_fsdp0_ids"], local = gen(dp, fsdp=True, fsdp_min_size=0)
    out["fsdp0_names"] = sorted(n for n, p in local.named_parameters()
                                if hasattr(p, "full_tensor"))

    # stage-2 steps: DP 2 (DDP), DP 2 + FSDP, TP 2
    batch = _tb(inp["batch"])
    for key, mesh, c, fmin in (
            ("dp", dp, cfg, None),
            ("fsdp", dp, cfg.replace(mesh=dataclasses.replace(
                cfg.mesh, fsdp=True)), FSDP_MIN),
            ("tp", tp, cfg, None)):
        st = _place_for_training(c, _port_model(state), mesh, fmin)
        if key == "fsdp":
            out["fsdp_names"] = sorted(
                n for n, p in st.model.named_parameters()
                if hasattr(p, "full_tensor"))
        out[f"{key}_loss"] = _sgd_step(st, M.shard_batch(batch, mesh))
        out[f"{key}_params"] = S.gather_state(
            dict(st.model.named_parameters()), mesh)

    # serving under TP 2: predict; under DP 2: the mesh pool
    tracks = _tracks()
    p = Predictor(cfg, state, batch_size=B, device="cpu", mesh=tp)
    out["predict"] = [r["pred_pixel_xy"] for r in p.predict(tracks)]
    p = Predictor(cfg, state, batch_size=B, device="cpu", mesh=dp)
    out["pool"] = [r["context"] for r in p.generate_context_batched(
        tracks, max_new_tokens=MAX_NEW, sampling=greedy, num_slots=B)]
    try:
        p.continuous_batcher(num_slots=3)
    except ValueError as e:
        out["pool_refusal"] = str(e)

    # the HTTP API under a mesh: rank 0 serves, broadcasting each request
    from tsue_tpu_torch.cli import serve as serve_cli
    args = serve_cli.parser().parse_args([
        "--device", "cpu", "--port", "0", "--serve-batch-size", str(B),
        "--max-new-tokens", str(MAX_NEW)])
    if rank == 0:
        srv = _serve(serve_cli, p, args)
        # a malformed body: answered by rank 0 alone, before any broadcast
        out["http_bad"] = _post(srv, "/generate", {"tracks": [],
                                                   "max_new_tokens": "x"})
        out["http"] = [np.asarray(r["pred_pixel_xy"]) for r in
                       _post(srv, "/predict", {"tracks": tracks})[1]
                       ["results"]]
        srv.shutdown()
        srv.server_close()
        M.broadcast_object(None)
    else:
        serve_cli.follow(p, args)

    # the generation eval: written once, by rank 0
    ds = build_track_text_dataset(tracks, cfg.data, ByteTokenizer())
    recs = distributed_generate_and_save(
        p.model.mllm, ByteTokenizer(), ds, os.path.join(d, "gen.txt"),
        seed=0, batch_size=B, max_new_tokens=MAX_NEW, cfg=greedy, mesh=dp)
    out["gen_records"] = recs

    # a checkpoint written by two ranks (TP 2)
    out["stage2"] = run_stage2(cfg, out_dir=os.path.join(d, "runs"),
                               epochs=1, synthetic_tracks=6, device="cpu",
                               eval_candidates=2, mesh=tp)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))

    # last: a request that fails on rank 1 alone.  Rank 1 logs it and
    # exits; rank 0, waiting in the request's gather, fails and answers 500
    if rank == 0:
        import time
        srv = _serve(serve_cli, p, args)
        t0 = time.perf_counter()
        code, body = _post(srv, "/predict", {"tracks": tracks})
        torch.save({"code": code, "body": body,
                    "s": time.perf_counter() - t0},
                   os.path.join(d, "http_fail.pt"))
        srv.shutdown()
        srv.server_close()
    else:
        def fail(*a, **kw):
            raise RuntimeError("a fault injected on rank 1")
        p.predict = fail
        serve_cli.follow(p, args)


def _serve(serve_cli, predictor, args):
    """``serve``'s HTTP API over ``predictor``, serving in a thread."""
    import threading
    srv = serve_cli.make_server(predictor, args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _post(srv, path, payload):
    """(status, decoded JSON body) of a POST to ``srv``."""
    import json
    import urllib.error
    import urllib.request
    body = json.dumps(payload, default=lambda a: a.tolist()).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}{path}", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _launch(d: str):
    """Start the two ranks; returns a function that waits for them (the
    references are computed meanwhile) and returns rank 1's log: rank 0
    exits 0, rank 1 with the fault injected at the end of ``_worker``."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), d], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))

    def wait():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert procs[0].returncode == 0, logs[0][-4000:]
        assert procs[1].returncode == 1, logs[1][-4000:]
        return logs[1]
    return wait


# ---------------------------------------------------------------------------
# The references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
    from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
    from tsue_tpu.ops.sampling import SamplingConfig as JaxSampling
    from tsue_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from tsue_tpu.parallel.serve_tp import (
        make_sharded_generate_fn as jax_sharded_generate)
    from tsue_tpu.parallel.sharding import shard_params
    from tsue_tpu.train import trainer as jax_trainer
    from tsue_tpu_torch.convert import load_flax_params
    from tsue_tpu_torch.eval.generation import (distributed_generate_and_save,
                                                make_generate_fn)
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.serve import Predictor
    from tsue_tpu_torch.train import trainer
    from tsue_tpu_torch.data.text_dataset import build_track_text_dataset
    import optax

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    d = str(tmp_path_factory.mktemp("parallel"))
    batch = _batches()[0]
    jcfg = _cfg(jax_config)
    jmodel = JaxTrajectoryModel(jcfg.model, 6, 6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
        False))(jb)["params"])
    model = load_flax_params(TrajectoryModel(_cfg(port_config).model, 6, 6),
                             params)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gen_in = _gen_inputs()
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump({"state": state, "batch": batch, "gen": gen_in}, f)
    wait = _launch(d)

    # the JAX package on two devices: TP 2 greedy generation
    jmesh = jax_make_mesh(model_parallel=2, devices=jax.devices()[:2])
    jmllm = JaxMLLM(llama=jcfg.model.llama, qformer=jcfg.model.qformer,
                    use_vision=True)
    jax_ids = {}
    for name, kw in FLAGS.items():
        g, _ = jax_sharded_generate(
            jmllm, {"params": params["mllm"]}, JaxSampling(do_sample=False),
            MAX_NEW, gen_in[1].shape[1], eos_id=383, mesh=jmesh, **kw)
        jax_ids[name] = np.asarray(g(*(jnp.asarray(a) for a in gen_in),
                                     jax.random.key(0)))

    # ... and its TP 2 step, clip + SGD
    tx = optax.chain(optax.clip_by_global_norm(jcfg.train.grad_clip),
                     optax.sgd(SGD_LR))
    jstate = jax_trainer.TrainState.create(
        lambda vs, b, det, rngs=None, **kw: jmodel.apply(
            vs, b, det, rngs=rngs, **kw),
        shard_params(params, jmesh), tx)
    with jmesh:
        jstate, jm = jax.jit(jax_trainer.make_train_step(jcfg))(
            jstate, jb, jax.random.key(7))
    jax_step = (float(jm["loss"]), _port_named(
        model, jax.device_get(jstate.params)))

    # the port in one process
    greedy = SamplingConfig(do_sample=False)
    vision, ids, mask = (torch.from_numpy(a) for a in gen_in)
    one_ids = {}
    for name, kw in FLAGS.items():
        mllm = _port_model(state).mllm
        if kw.get("quantize_decode"):
            from tsue_tpu_torch.ops.quant import (attach_quant,
                                                  quantize_llama_params)
            attach_quant(mllm, quantize_llama_params(mllm))
        g = make_generate_fn(mllm, greedy, MAX_NEW, ids.shape[1], 383,
                             fused_head=kw.get("fused_head", False),
                             quantize_kv=kw.get("quantize_kv", False))
        one_ids[name] = g(vision, ids, mask, torch.Generator().manual_seed(0))
    st = trainer.TrainState(_port_model(state), None, 0)
    st.optimizer = trainer.make_optimizer(_cfg(port_config), st.model)
    one_loss = _sgd_step(st, _tb(batch))
    one_params = {k: v.detach().clone()
                  for k, v in st.model.named_parameters()}
    tracks = _tracks()
    p = Predictor(_cfg(port_config), state, batch_size=B, device="cpu")
    one_predict = [r["pred_pixel_xy"] for r in p.predict(tracks)]
    one_pool = [r["context"] for r in p.generate_context_batched(
        tracks, max_new_tokens=MAX_NEW, sampling=greedy, num_slots=B)]
    ds = build_track_text_dataset(tracks, _cfg(port_config).data,
                                  ByteTokenizer())
    one_gen = distributed_generate_and_save(
        p.model.mllm, ByteTokenizer(), ds, os.path.join(d, "gen1.txt"),
        seed=0, batch_size=B, max_new_tokens=MAX_NEW, cfg=greedy)
    log1 = wait()
    outs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]
    yield dict(d=d, outs=outs, jax_ids=jax_ids, jax_step=jax_step,
               one_ids=one_ids, one_loss=one_loss, one_params=one_params,
               state=state, one_predict=one_predict, one_pool=one_pool,
               one_gen=one_gen, params=params, log1=log1,
               http_fail=torch.load(os.path.join(d, "http_fail.pt"),
                                    weights_only=False))
    torch.set_num_threads(prev)


def _port_named(model, tree):
    """{port name: tensor in the port's layout} of a Flax tree."""
    from tsue_tpu_torch.convert import _convert_leaf, _flatten
    modules = dict(model.named_modules())
    out = {}
    for path, value in _flatten(tree).items():
        mod = ".".join(path[:-1])
        name, arr = _convert_leaf(modules[mod], path[-1], value,
                                  "/".join(path))
        out[f"{mod}.{name}"] = torch.from_numpy(np.array(arr, np.float32))
    return out


def _assert_updates_close(ref, other, orig, rel=1e-5):
    """``tests/test_multichip.py:54-71``'s rule: every parameter's
    difference within ``rel`` of the largest update."""
    scale = max(float((ref[k] - orig[k]).abs().max()) for k in ref)
    assert scale > 0, "the step moved no parameter"
    for k in ref:
        diff = float((ref[k] - other[k]).abs().max())
        assert diff <= rel * scale + 1e-8, (k, diff, rel * scale)


# ---------------------------------------------------------------------------
# Pure functions
# ---------------------------------------------------------------------------

MESHES = {
    "tp2": ({"data": 1, "model": 2}, False),
    "fsdp2": ({"data": 2, "model": 1}, True),
    "tp2_fsdp2": ({"data": 2, "model": 2}, True),
    "tp3_fallback": ({"data": 1, "model": 3}, False),
}


@pytest.fixture(scope="module")
def shapes():
    """The JAX package's parameter and int8 trees (shapes only), and the
    port's model and tables."""
    from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
    from tsue_tpu.ops.quant import quantize_llama_params as jax_quantize
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.ops.quant import quantize_llama_params
    jcfg = _cfg(jax_config)
    jb = {k: jnp.asarray(v) for k, v in _batches()[0].items()}
    params = jax.eval_shape(lambda b: JaxTrajectoryModel(jcfg.model, 6, 6)
                            .init({"params": jax.random.key(0),
                                   "dropout": jax.random.key(1)}, b,
                                  False), jb)["params"]
    quant = jax.eval_shape(jax_quantize, params["mllm"])
    from tsue_tpu_torch.models.tsue import init_params
    model = init_params(TrajectoryModel(_cfg(port_config).model, 6, 6),
                        torch.Generator().manual_seed(0))
    tables = quantize_llama_params(model.mllm)
    return params, quant, model, tables


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_spec(path, leaf, mesh_shape, fsdp):
    from tsue_tpu.parallel.sharding import _resolve
    return tuple(_resolve(path, leaf, types.SimpleNamespace(
        shape=mesh_shape), fsdp, FSDP_MIN))


@pytest.mark.parametrize("case", sorted(MESHES))
def test_rules_resolve_like_jax(shapes, case):
    """Every parameter and int8 table: the port's spec is the JAX
    package's for the same Flax path, in the port's layout (a ``Linear``'s
    (out, in) takes the axes of the Flax kernel's out dims and in dims)."""
    from torch import nn
    params, quant, model, tables = shapes
    mesh_shape, fsdp = MESHES[case]
    ours = S.param_specs(model, mesh_shape, fsdp, FSDP_MIN)
    modules = dict(model.named_modules())
    seen = set()
    for path, leaf in _flat(params):
        mod = modules[".".join(path[:-1])]
        want = _jax_spec(path, leaf, mesh_shape, fsdp)
        if isinstance(mod, nn.Linear) and path[-1] == "kernel":
            name = ".".join(path[:-1]) + ".weight"
            split = next(i for i in range(1, leaf.ndim + 1)
                         if np.prod(leaf.shape[:i]) == mod.in_features)
            ent = list(want) + [None] * (leaf.ndim - len(want))
            ax = [next((a for a in ent[g] if a), None)
                  for g in (slice(split, None), slice(0, split))]
            want = tuple(ax) if any(ax) else ()
        else:
            leaf_name = {"embedding": "weight"}.get(path[-1], path[-1])
            if isinstance(mod, nn.LayerNorm):
                leaf_name = {"scale": "weight"}.get(path[-1], path[-1])
            name = ".".join(path[:-1] + (leaf_name,))
            if isinstance(mod, nn.Linear):
                want = tuple(want)
        assert ours[name] == want, (name, ours[name], want)
        seen.add(name)
    assert seen == set(ours)
    if fsdp:
        return
    # the int8 tables: the TP rules alone
    for path, leaf in _flat(quant):
        name = ".".join(path)
        assert name in tables, name
        want = _jax_spec(("quant",) + path, leaf, mesh_shape, False)
        got = S.tp_spec(name, tuple(tables[name].shape), mesh_shape)
        assert got == tuple(want), (name, got, want)


def test_shard_state_round_trip(shapes):
    """Two model ranks' ``shard_state`` cuts, joined along each spec's
    model dim, are the full state; the local-shard model takes them."""
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    _, _, model, tables = shapes
    full = dict(model.state_dict(), **{"mllm." + k: v
                                       for k, v in tables.items()})
    cuts = [S.shard_state(full, M.Mesh(model=2, model_rank=r))
            for r in range(2)]
    cut_any = False
    for k, v in full.items():
        spec = S.tp_spec(k, tuple(v.shape), {"data": 1, "model": 2})
        if "model" in spec:
            cut_any = True
            dim = spec.index("model")
            assert cuts[0][k].shape[dim] * 2 == v.shape[dim]
            torch.testing.assert_close(torch.cat([c[k] for c in cuts], dim),
                                       v, rtol=0, atol=0)
        else:
            assert cuts[0][k] is v or torch.equal(cuts[0][k], v)
    assert cut_any
    local = TrajectoryModel(_cfg(port_config).model, 6, 6,
                            mesh=M.Mesh(model=2, model_rank=1))
    local.load_state_dict({k: v for k, v in cuts[1].items()
                           if k in dict(local.named_parameters())})


def test_make_mesh_one_process():
    """One process: the world is 1, so a model degree of 2 raises."""
    mesh = M.make_mesh(1, device="cpu")
    assert (mesh.data, mesh.model, mesh.rank) == (1, 1, 0)
    with pytest.raises(ValueError, match="must divide the world size 1"):
        M.make_mesh(2, device="cpu")
    batch = {"x": np.arange(8)}
    assert M.shard_batch(batch, mesh)["x"] is batch["x"]


def test_shard_batch_rows():
    mesh = M.Mesh(data=2, data_rank=1)
    out = M.shard_batch({"x": np.arange(8), "y": torch.arange(4)}, mesh)
    np.testing.assert_array_equal(out["x"], [4, 5, 6, 7])
    assert out["y"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="must divide the data axis"):
        M.shard_batch({"x": np.arange(3)}, mesh)


def test_tensor_parallel_needs_divisible_heads():
    from tsue_tpu_torch.models.llama import local_config
    c = port_config.LlamaConfig.tiny()
    with pytest.raises(ValueError, match="model_parallel=3"):
        local_config(c, M.Mesh(model=3))
    lc = local_config(c, M.Mesh(model=2))
    assert (lc.num_heads, lc.num_kv_heads, lc.intermediate_size) == (2, 1, 64)


def test_initialize_distributed_contract(monkeypatch):
    """Without torchrun's environment: one process, nothing joined; with
    a partial one: an error, never a silent one-process run."""
    for k in M.TORCHRUN_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert M.initialize_distributed("gloo") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="torchrun"):
        M.initialize_distributed("gloo")


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------

def test_ranks_layout(ranks):
    """TP 2 is (data 1, model 2); DP 2 is (data 2, model 1)."""
    assert [o["mesh"] for o in ranks["outs"]] == [(1, 2, 0, 2, 0),
                                                  (1, 2, 1, 2, 1)]
    # q_proj (128, 4 x 32) cut to this rank's 2 heads
    assert ranks["outs"][0]["tp_q_shape"] == (128, 64)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_tp2_generation_matches_jax(ranks, flags):
    """TP 2 greedy ids against the JAX package's TP 2 and the port's one
    process: agreement on at least 0.9 of the positions
    (``tests/test_serve_tp.py:69``); measured 1.0 at this size."""
    for o in ranks["outs"]:
        ids = o[f"tp_ids_{flags}"].numpy()
        assert ids.shape == (B, MAX_NEW)
        assert (ids == ranks["jax_ids"][flags]).mean() >= 0.9
        assert (ids == ranks["one_ids"][flags].numpy()).mean() >= 0.9
    assert torch.equal(ranks["outs"][0][f"tp_ids_{flags}"],
                       ranks["outs"][1][f"tp_ids_{flags}"])


def test_dp2_generation_row_for_row(ranks):
    """Pure DP 2 (with and without FSDP) is the one-process decode, row
    for row."""
    for o in ranks["outs"]:
        assert torch.equal(o["dp_ids"], ranks["one_ids"]["off"])
        assert torch.equal(o["dp_fsdp_ids"], ranks["one_ids"]["off"])


@pytest.mark.parametrize("key", ["dp", "fsdp", "tp"])
def test_stage2_step_matches_one_process_and_jax(ranks, key):
    """A DP 2, DP 2 + FSDP or TP 2 step against the one-process step and
    the JAX package's TP 2 step: the loss within rtol 1e-5, every update
    within 1e-5 of the largest."""
    orig = {k: v for k, v in ranks["state"].items()
            if k in ranks["one_params"]}
    jloss, jparams = ranks["jax_step"]
    for o in ranks["outs"]:
        assert o[f"{key}_loss"] == pytest.approx(ranks["one_loss"],
                                                 rel=1e-5)
        assert o[f"{key}_loss"] == pytest.approx(jloss, rel=1e-5)
        got = {k: v.float() for k, v in o[f"{key}_params"].items()}
        assert set(got) == set(ranks["one_params"])
        _assert_updates_close(ranks["one_params"], got, orig)
        _assert_updates_close(jparams, got, orig)


def _jax_fsdp_names(shapes, min_size, sub=()):
    """The port names of the parameters that the JAX package's
    ``_resolve`` puts on "data" at DP 2 with FSDP and ``min_size``, in the
    subtree ``sub`` (names relative to it)."""
    from torch import nn
    from tsue_tpu.parallel.sharding import _resolve
    params, _, model, _ = shapes
    modules = dict(model.named_modules())
    want = set()
    for path, leaf in _flat(params):
        if path[:len(sub)] != sub or "data" not in _resolve(
                path, leaf, types.SimpleNamespace(
                    shape={"data": 2, "model": 1}), True, min_size):
            continue
        mod = modules[".".join(path[:-1])]
        leaf_name = path[-1]
        if (isinstance(mod, (nn.Linear, nn.Embedding))
                and leaf_name in ("kernel", "embedding")) or (
                isinstance(mod, nn.LayerNorm) and leaf_name == "scale"):
            leaf_name = "weight"
        want.add(".".join(path[len(sub):-1] + (leaf_name,)))
    assert want
    return want


def test_fsdp_shards_what_jax_would(ranks, shapes):
    """FSDP2 shards exactly the parameters that the JAX package's
    ``_fsdp_augment`` puts on "data" (at this threshold)."""
    want = _jax_fsdp_names(shapes, FSDP_MIN)
    for o in ranks["outs"]:
        assert set(o["fsdp_names"]) == want


def test_fsdp_min_size_zero_shards_what_jax_would(ranks, shapes):
    """``fsdp_min_size=0`` is a threshold of 0, as in the JAX package (not
    the default): the sharded MLLM's FSDP parameters are those ``_resolve``
    puts on "data" at 0, and its greedy ids the one-process ids."""
    want = _jax_fsdp_names(shapes, 0, ("mllm",))
    assert want > _jax_fsdp_names(shapes, FSDP_MIN, ("mllm",))
    for o in ranks["outs"]:
        assert set(o["fsdp0_names"]) == want
        assert torch.equal(o["dp_fsdp0_ids"], ranks["one_ids"]["off"])


def test_predict_under_tp2(ranks):
    for o in ranks["outs"]:
        assert len(o["predict"]) == len(ranks["one_predict"]) > 0
        for a, b in zip(o["predict"], ranks["one_predict"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)


def test_http_under_a_mesh(ranks):
    """``serve``'s HTTP API over a DP 2 predictor: rank 0 answers a
    /predict request that rank 1 ran beside it (``cli.serve.follow``),
    with the one-process predictions."""
    got = ranks["outs"][0]["http"]
    assert len(got) == len(ranks["one_predict"]) > 0
    for a, b in zip(got, ranks["one_predict"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)


def test_http_malformed_request_is_answered_by_rank_0(ranks):
    """A body that does not parse is answered 500 by rank 0 before any
    broadcast; the mesh then serves the next request
    (``test_http_under_a_mesh``)."""
    code, body = ranks["outs"][0]["http_bad"]
    assert code == 500 and body["error"].startswith("ValueError"), body


def test_http_request_failing_on_one_rank(ranks):
    """A request that fails on rank 1 alone: rank 1 logs the error with
    its traceback and exits 1 (``_launch``); rank 0, waiting in the
    request's collective, fails at once instead of at the process
    group's timeout, and answers 500."""
    fail = ranks["http_fail"]
    assert fail["code"] == 500, fail
    assert fail["s"] < 60, fail
    log = ranks["log1"]
    assert "rank 1: the /predict request failed; leaving the mesh" in log
    assert "RuntimeError: a fault injected on rank 1" in log


def test_mesh_pool(ranks):
    """The slot pool sharded over DP 2 gives the one-process pool's texts,
    and refuses a slot count the data axis does not divide."""
    for o in ranks["outs"]:
        assert o["pool"] == ranks["one_pool"]
        assert "must divide the mesh's data axis" in o["pool_refusal"]


def test_distributed_generate_and_save(ranks):
    """Rank 0 writes the file once, equal to one process's; rank 1
    returns no records."""
    outs = ranks["outs"]
    assert outs[0]["gen_records"] == ranks["one_gen"]
    assert outs[1]["gen_records"] == []
    with open(os.path.join(ranks["d"], "gen.txt")) as f, \
            open(os.path.join(ranks["d"], "gen1.txt")) as g:
        assert f.read() == g.read()


def test_checkpoint_from_two_ranks_restores_in_one(ranks):
    """``run_stage2`` at TP 2 writes the one-process artifact: restored in
    one process, its test metrics are the two ranks' (global, equal on
    both)."""
    from tsue_tpu_torch.runner import run_stage2
    cfg = _cfg(port_config)
    a, b = (o["stage2"] for o in ranks["outs"])
    assert a == b
    best = os.path.join(ranks["d"], "runs", cfg.name, "ckpt", "best")
    one = run_stage2(cfg, out_dir=os.path.join(ranks["d"], "one"), epochs=0,
                     restore_ckpt=best, synthetic_tracks=6, device="cpu",
                     eval_candidates=2)
    assert set(one) == set(a)
    for k in ("test_ade", "test_fde", "min_ade", "min_fde", "min_rmse"):
        assert one[k] == pytest.approx(a[k], rel=1e-5)


# ---------------------------------------------------------------------------
# The CLI under torch.distributed.run
# ---------------------------------------------------------------------------

def test_cli_serve_under_torchrun(tmp_path):
    """``serve --model-parallel 2`` launched by torchrun on two CPU
    ranks: rank 0 writes the predictions, as one process would."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    outs = {}
    for tag, launch in (
            ("tp", [sys.executable, "-m", "torch.distributed.run",
                    "--nproc_per_node", "2", "--master_addr", "localhost",
                    "--master_port", str(port), "-m", "tsue_tpu_torch.cli"]),
            ("one", [sys.executable, "-m", "tsue_tpu_torch.cli"])):
        out = tmp_path / f"{tag}.jsonl"
        argv = ["serve", "--tiny", "--device", "cpu", "--preset",
                "test_18_18", "--synthetic-tracks", "2",
                "--serve-batch-size", "4", "--out", str(out)]
        if tag == "tp":
            argv += ["--model-parallel", "2"]
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        r = subprocess.run(launch + argv, cwd=ROOT, env=env, timeout=TIMEOUT_S,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        outs[tag] = [__import__("json").loads(x)
                     for x in out.read_text().splitlines()]
    assert len(outs["tp"]) == len(outs["one"]) > 0
    for a, b in zip(outs["tp"], outs["one"]):
        assert a["track_id"] == b["track_id"]
        np.testing.assert_allclose(a["pred_pixel_xy"], b["pred_pixel_xy"],
                                   rtol=1e-5, atol=1e-3)


if __name__ == "__main__":
    _worker(sys.argv[1])
