"""The port's GPipe pipeline (``tsue_tpu_torch/parallel/pipeline.py``), its
point-to-point sends and the sharded stage-2 train state, against the JAX
package and the port in one process, on the CPU over gloo.

One launch of four ranks (this file run as a script with torchrun's
environment; a rank that outlives ``TIMEOUT_S`` is killed and the test
fails) runs every multi-process case while this process computes the
references, and ``stage1 --pipeline-parallel 2`` runs under
``torch.distributed.run`` on two more ranks beside it:

- the pipelined LM loss at pp 2 x dp 2 (2 microbatches), pp 4 (2 and 4:
  more microbatches than stages) and with ``loss_chunk``, each within rtol
  2e-5 of the JAX package's pipelined loss at pp 2 x dp 2 on four CPU
  devices or its one-device ``lm_loss``, and of the port's one-process
  ``lm_loss``;
- one pipelined stage-1 step (pp 2 x dp 2) against the JAX one-device
  step at ``tests/test_pipeline.py``'s tolerances and the port's
  one-process step, the base Llama frozen; the eval step deterministic;
  with dropout on, a repeated step bit-identical and the two data ranks'
  masks different; the errors;
- a TP 2 x DP 2 stage-2 step against one process and the JAX package's
  2 x 2 mesh; ``run_stage2`` under TP 2 x DP 2 and under FSDP over DP 4,
  interrupted after one epoch and resumed to two, equal bit for bit to the
  straight run; a train state written by the ranks restored and saved
  again in one process, and one written by one process restored and saved
  again under each mesh, bit for bit.

The MLLM is ``tests/test_pipeline.py``'s: a 4-layer tiny Llama (vocab 64),
a 1 + 1 Q-Former, B 8, every dropout 0 unless said.  The stage-2 model is
``tests/test_torch_parallel.py``'s train-parity TrajectoryModel.
"""
import dataclasses
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time

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
from tsue_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from tsue_tpu_torch.parallel import mesh as M  # noqa: E402
from tsue_tpu_torch.parallel import pipeline as P  # noqa: E402

TIMEOUT_S = 240
WORLD = 4
VOCAB, PROMPT_LEN, T_VIS, B = 64, 12, 4, 8
LR = 1e-2
CHUNK = 5
S2_B, S2_TRACKS = 8, 5
FSDP_MIN = 16384
LOSSES = {  # key: (pipe degree, microbatches, loss_chunk)
    "pp2_dp2_m2": (2, 2, 0), "pp4_m2": (4, 2, 0), "pp4_m4": (4, 4, 0),
    "pp4_m2_chunk": (4, 2, CHUNK)}


def _llama(c, dropout=0.0, chunk=0):
    return dataclasses.replace(c.LlamaConfig.tiny(VOCAB), num_layers=4,
                               lora_dropout=dropout, loss_chunk=chunk)


def _qformer(c, dropout=0.0):
    return c.QFormerConfig(hidden_size=32, num_heads=2, num_encoder_layers=1,
                           num_decoder_layers=1, num_query_tokens=4,
                           dropout=dropout)


def _stage1_cfg(c, dropout=0.0):
    return c.ExperimentConfig(
        name="pp", model=c.ModelConfig(llama=_llama(c, dropout),
                                       qformer=_qformer(c, dropout)),
        train=c.TrainConfig(batch_size=B, lr=LR))


def _batch():
    """Random ids; two rows padded at the end; labels -100 over the first
    3 (the prompt) and the padding."""
    rng = np.random.default_rng(0)
    mask = np.ones((B, PROMPT_LEN), np.int32)
    mask[1, 9:] = 0
    mask[6, 7:] = 0
    ids = (rng.integers(3, VOCAB - 1, (B, PROMPT_LEN)) * mask).astype(
        np.int32)
    labels = np.where(mask > 0, ids, -100)
    labels[:, :3] = -100
    return dict(vision=rng.standard_normal((B, T_VIS, 512)).astype(
        np.float32), input_ids=ids, attention_mask=mask,
        labels=labels.astype(np.int32))


def _s2_cfg(c, regime="joint"):
    """``tests/test_torch_parallel.py``'s train-parity configuration."""
    return c.ExperimentConfig(
        name="torch_pipeline_s2",
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
        train=c.TrainConfig(batch_size=S2_B, freeze_regime=regime))


def _s2_batch():
    from tsue_tpu_torch.data import (BatchIterator, build_windows,
                                     make_synthetic_tracks)
    ds = build_windows(make_synthetic_tracks(num_tracks=3, track_len=300,
                                             seed=1), _s2_cfg(port_config)
                       .data, ByteTokenizer())
    b = next(iter(BatchIterator(ds, 4, shuffle=True, seed=42)))
    return dict(b, polygon=b["polygon"] / 1000.0)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _mllm(state, dropout=0.0, chunk=0):
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    m = MultiModalLLM(dataclasses.replace(_llama(port_config, dropout),
                                          loss_chunk=chunk),
                      _qformer(port_config, dropout))
    m.load_state_dict(state)
    return m


def _s2_model(state):
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    model = TrajectoryModel(_s2_cfg(port_config).model, 6, 6)
    model.load_state_dict(state)
    return model


def _sgd_step(state, batch):
    """One stage-2 step with the guarded clip and SGD at lr 1 in place of
    AdamW (``tests/test_torch_parallel.py``)."""
    from tsue_tpu_torch.train import trainer
    state.optimizer.adamw = torch.optim.SGD(state.optimizer.params, lr=1.0,
                                            foreach=False)
    return float(trainer.make_train_step(_s2_cfg(port_config))(
        state, batch)["loss"])


def _state_file(run_dir):
    from tsue_tpu_torch.train.checkpoint import STATE_FILE
    return torch.load(os.path.join(run_dir, "torch_pipeline_s2", "ckpt",
                                   "state", STATE_FILE), weights_only=True)


def _resave(mesh, src, dst):
    """Restore the train state at ``src`` into a freshly placed state (one
    process without ``mesh``) and save it again to ``dst``."""
    from tsue_tpu_torch.runner import _place_for_training
    from tsue_tpu_torch.train import checkpoint as ck
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    cfg = _s2_cfg(port_config).replace(mesh=dataclasses.replace(
        port_config.MeshConfig(), fsdp=mesh is not None and mesh.model == 1))
    model = TrajectoryModel(cfg.model, 6, 6)
    tf = ck.trainable_filter(model, cfg.train.freeze_regime)
    st = _place_for_training(cfg, model, mesh, FSDP_MIN)
    _, extra = ck.restore_train_state(src, st, trainable_filter=tf)
    ck.save_train_state(dst, st, trainable_filter=tf, **extra)


# ---------------------------------------------------------------------------
# The four ranks (this file as a script)
# ---------------------------------------------------------------------------

def _pp_state(cfg, state, mesh, dropout=0.0):
    from tsue_tpu_torch.train.stage1 import make_stage1_optimizer
    from tsue_tpu_torch.train.trainer import TrainState
    stage = P.stage_of(_mllm(state, dropout), mesh)
    return TrainState(stage, make_stage1_optimizer(cfg, stage, mesh=mesh),
                      0, mesh=mesh)


def _worker(d: str) -> None:
    import copy
    import torch.distributed as dist
    from tsue_tpu_torch.parallel import sharding as S
    from tsue_tpu_torch.runner import (_place_for_training, run_stage1,
                                       run_stage2)
    torch.set_num_threads(1)
    assert M.initialize_distributed("gloo")
    rank = dist.get_rank()
    with open(os.path.join(d, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    state, batch = inp["mllm"], _tb(inp["batch"])
    pp2 = P.make_pipeline_mesh(2, "cpu")
    pp4 = P.make_pipeline_mesh(4, "cpu")
    out = {"layout": [(m.data, m.pipe, m.data_rank, m.pipe_rank,
                       dist.get_process_group_ranks(m.pipe_group))
                      for m in (pp2, pp4)], "errors": {}}
    meshes = {2: pp2, 4: pp4}

    def error(key, fn):
        try:
            fn()
        except ValueError as e:
            out["errors"][key] = str(e)

    # the pipelined loss, deterministic
    M.reset_counts()
    for key, (pp, n, chunk) in LOSSES.items():
        mesh = meshes[pp]
        stage = P.stage_of(_mllm(state, chunk=chunk), mesh)
        with torch.no_grad():
            out[f"loss_{key}"] = float(P.pipelined_lm_loss(
                stage, mesh, M.shard_batch(batch, mesh), n))
    out["counts"] = dict(M.COUNTS)
    error("pp3", lambda: P.make_pipeline_mesh(3, "cpu"))
    error("micro", lambda: P.pipelined_lm_loss(stage, pp4, batch, 3))
    bad = _stage1_cfg(port_config)
    bad = bad.replace(train=dataclasses.replace(bad.train, batch_size=5),
                      mesh=dataclasses.replace(bad.mesh, pipeline_parallel=2))
    error("batch", lambda: run_stage1(bad, out_dir=os.path.join(d, "bad"),
                                      epochs=0, device="cpu"))

    # one step at pp 2 x dp 2, its eval before it twice
    cfg = _stage1_cfg(port_config)
    st = _pp_state(cfg, state, pp2)
    train_step, eval_step = P.make_pipelined_stage1_step(pp2, 2)
    rows = M.shard_batch(batch, pp2)
    out["eval"] = [float(eval_step(st, rows)["lm_loss"]) for _ in range(2)]
    out["step_loss"] = float(train_step(st, rows, 3, 0)["lm_loss"])
    joined = P.gather_stages(st.model, pp2)
    if rank == 0:
        out["step_params"] = joined
    # the same step with clip + SGD at lr 1: an update affine in the
    # gradient, where AdamW's first step is about lr * sign(g)
    st = _pp_state(cfg, state, pp2)
    st.optimizer.adamw = torch.optim.SGD(st.optimizer.params, lr=1.0,
                                         foreach=False)
    out["sgd_loss"] = float(train_step(st, rows, 3, 0)["lm_loss"])
    joined = P.gather_stages(st.model, pp2)
    if rank == 0:
        out["sgd_params"] = joined

    # dropout on: a repeated step bit-identical ...
    st = _pp_state(_stage1_cfg(port_config, 0.1), state, pp2, 0.1)
    params = dict(st.model.named_parameters())
    snap = {n: p.detach().clone() for n, p in params.items()}
    opt = copy.deepcopy(st.optimizer.state_dict())
    runs = []
    for _ in range(2):
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(snap[n])
        st.optimizer.load_state_dict(copy.deepcopy(opt))
        loss = float(train_step(st, rows, 5, 1)["lm_loss"])
        runs.append((loss, {n: p.detach().clone()
                            for n, p in params.items()}))
    out["dropout_repeat"] = (runs[0][0] == runs[1][0] and all(
        torch.equal(runs[0][1][n], runs[1][1][n]) for n in params))
    out["dropout_moved"] = any(not torch.equal(runs[0][1][n], snap[n])
                               for n in params)
    # ... and the two data ranks' masks different: the same rows on both,
    # a LoRA B gradient of each stage before any sum
    for drop in (0.0, 0.1):
        stage = P.stage_of(_mllm(state, drop), pp2)
        P.pipelined_lm_loss(stage, pp2, {k: v[:4] for k, v in batch.items()},
                            2, P.microbatch_generators(pp2, 2, 5, 1, "cpu"),
                            backward=True)
        name = next(n for n, _ in stage.named_parameters()
                    if P.layer_index(n) is not None and n.endswith("lora_b"))
        out[f"lora_grad_{drop}"] = dict(stage.named_parameters())[name].grad

    # stage 2: a TP 2 x DP 2 step (clip + SGD)
    tp = M.make_mesh(2, device="cpu")
    dp4 = M.make_mesh(1, device="cpu")
    s2 = _place_for_training(_s2_cfg(port_config), _s2_model(inp["s2"]), tp)
    out["tp_loss"] = _sgd_step(s2, M.shard_batch(_tb(inp["s2_batch"]), tp))
    whole = S.gather_state(dict(s2.model.named_parameters()), tp)
    if rank == 0:
        out["tp_params"] = whole

    # run_stage2 interrupted after an epoch and resumed, under TP 2 x DP 2
    # and under FSDP over DP 4
    S.FSDP_MIN_SIZE = FSDP_MIN
    run = dict(synthetic_tracks=S2_TRACKS, device="cpu", save_every=1)
    for key, mesh, fsdp in (("tp", tp, False), ("fsdp", dp4, True)):
        c = _s2_cfg(port_config).replace(mesh=dataclasses.replace(
            port_config.MeshConfig(), fsdp=fsdp))
        base = os.path.join(d, key)
        out[f"{key}_straight"] = run_stage2(
            c, out_dir=os.path.join(base, "a"), epochs=2, mesh=mesh, **run)
        run_stage2(c, out_dir=os.path.join(base, "b"), epochs=1, mesh=mesh,
                   **run)
        if rank == 0:      # the epoch-1 checkpoints, for one process
            shutil.copytree(os.path.join(base, "b", c.name, "ckpt"),
                            os.path.join(base, "epoch1"))
        M.barrier()
        out[f"{key}_resumed"] = run_stage2(
            c, out_dir=os.path.join(base, "b"), epochs=2, resume=True,
            mesh=mesh, **run)
        # the one process's epoch-1 file: restored and saved again here
        while not os.path.exists(os.path.join(d, "one", "written")):
            time.sleep(0.1)
        _resave(mesh, os.path.join(d, "one", c.name, "ckpt", "state"),
                os.path.join(base, "from_one"))
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(d: str):
    """Start the four ranks and, beside them, ``stage1 --pipeline-parallel
    2`` under torch.distributed.run on two; returns a function that waits
    for all and returns the CLI run's output."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), d],
        env=dict(env, WORLD_SIZE=str(WORLD), RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "localhost", "--master_port",
         str(_free_port()), "-m", "tsue_tpu_torch.cli", "stage1", "--tiny",
         "--device", "cpu", "--epochs", "1", "--synthetic-tracks", "2",
         "--batch-size", "8", "--pipeline-parallel", "2", "--microbatches",
         "2", "--out-dir", os.path.join(d, "cli"), "--export",
         os.path.join(d, "cli_export")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    def wait():
        logs = []
        try:
            for p in procs + [cli]:
                logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
        finally:
            for p in procs + [cli]:
                if p.poll() is None:
                    p.kill()
        for p, log in zip(procs + [cli], logs):
            assert p.returncode == 0, log[-4000:]
        return logs[-1]
    return wait


# ---------------------------------------------------------------------------
# The references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tsue_tpu.models.fusion import MultiModalLLM as JaxMLLM
    from tsue_tpu.models.tsue import TrajectoryModel as JaxTrajectoryModel
    from tsue_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from tsue_tpu.parallel import pipeline as jax_pipeline
    from tsue_tpu.parallel.sharding import shard_params
    from tsue_tpu.train import stage1 as jax_stage1
    from tsue_tpu.train import trainer as jax_trainer
    from tsue_tpu_torch.convert import load_flax_params
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.runner import run_stage2
    from tsue_tpu_torch.train import stage1, trainer
    from tsue_tpu_torch.train.trainer import TrainState
    from tsue_tpu_torch.utils.random import step_generator
    import optax

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    d = str(tmp_path_factory.mktemp("pipeline"))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmllm = JaxMLLM(_llama(jax_config), _qformer(jax_config))
    params = jax.device_get(jax.jit(lambda b: jmllm.init(
        {"params": jax.random.key(0)}, b["vision"], b["input_ids"],
        b["attention_mask"], True))(jb)["params"])
    mllm_state = load_flax_params(
        MultiModalLLM(_llama(port_config), _qformer(port_config)),
        params).state_dict()
    s2cfg = _s2_cfg(jax_config)
    s2batch = _s2_batch()
    s2jb = {k: jnp.asarray(v) for k, v in s2batch.items()}
    jmodel = JaxTrajectoryModel(s2cfg.model, 6, 6)
    s2params = jax.device_get(jax.jit(lambda b: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
        False))(s2jb)["params"])
    s2state = load_flax_params(TrajectoryModel(_s2_cfg(port_config).model,
                                               6, 6), s2params).state_dict()
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump({"mllm": mllm_state, "batch": batch, "s2": s2state,
                     "s2_batch": s2batch}, f)
    wait = _launch(d)
    # the one process's epoch-1 train state, which the ranks resume last
    run_stage2(_s2_cfg(port_config), out_dir=os.path.join(d, "one"),
               epochs=1, synthetic_tracks=S2_TRACKS, device="cpu",
               save_every=1)
    open(os.path.join(d, "one", "written"), "w").close()

    # the JAX package: the pipelined loss at pp 2 x dp 2 on four devices,
    # the one-device loss and stage-1 step
    jmesh = jax_pipeline.make_pipeline_mesh(2, jax.devices()[:4])
    pp_params = jax_pipeline.place_pipeline_params(dict(zip(
        ("outer", "layers"), jax_pipeline.split_llama_layers(params, 2))),
        jmesh)
    jax_pp = float(jax.jit(jax_pipeline.make_pipelined_lm_loss(
        jmllm, jmesh, 2))(pp_params, jb, jax.random.key(0)))
    jax_loss = float(jax.jit(lambda p, b: jmllm.apply(
        {"params": p}, b["vision"], b["input_ids"], b["attention_mask"],
        b["labels"], True, method=jmllm.lm_loss))(params, jb))
    jcfg = _stage1_cfg(jax_config)
    tx = jax_stage1.make_stage1_optimizer(jcfg, params)
    jp, _, jm = jax.jit(jax_stage1.make_stage1_train_step(jmllm, tx))(
        params, tx.init(params), jb, jax.random.key(3))
    jax_step = (float(jm["lm_loss"]), load_flax_params(
        MultiModalLLM(_llama(port_config), _qformer(port_config)),
        jax.device_get(jp)).state_dict())

    # ... and its stage-2 step on a 2 x 2 (data, model) mesh, clip + SGD
    s2mesh = jax_make_mesh(model_parallel=2, devices=jax.devices()[:4])
    s2tx = optax.chain(optax.clip_by_global_norm(s2cfg.train.grad_clip),
                       optax.sgd(1.0))
    jstate = jax_trainer.TrainState.create(
        lambda vs, b, det, rngs=None, **kw: jmodel.apply(
            vs, b, det, rngs=rngs, **kw),
        shard_params(s2params, s2mesh), s2tx)
    with s2mesh:
        jstate, jm2 = jax.jit(jax_trainer.make_train_step(
            _s2_cfg(jax_config)))(jstate, s2jb, jax.random.key(7))
    jax_s2 = (float(jm2["loss"]), {k: v for k, v in load_flax_params(
        TrajectoryModel(_s2_cfg(port_config).model, 6, 6),
        jax.device_get(jstate.params)).named_parameters()})

    # the port in one process
    tb = _tb(batch)
    one_loss = {}
    for chunk in (0, CHUNK):
        with torch.no_grad():
            one_loss[chunk] = float(_mllm(mllm_state, chunk=chunk).lm_loss(
                tb["vision"], tb["input_ids"], tb["attention_mask"],
                tb["labels"]))
    m = _mllm(mllm_state)
    st = TrainState(m, stage1.make_stage1_optimizer(
        _stage1_cfg(port_config), m), 0)
    one_step = (float(stage1.make_stage1_train_step()(
        st, tb, step_generator(3, 0))["lm_loss"]),
        {k: v.detach().clone() for k, v in m.state_dict().items()})
    m = _mllm(mllm_state)
    st = TrainState(m, stage1.make_stage1_optimizer(
        _stage1_cfg(port_config), m), 0)
    st.optimizer.adamw = torch.optim.SGD(st.optimizer.params, lr=1.0,
                                         foreach=False)
    one_sgd = (float(stage1.make_stage1_train_step()(
        st, tb, step_generator(3, 0))["lm_loss"]),
        {k: v.detach().clone() for k, v in m.state_dict().items()})
    s2st = TrainState(_s2_model(s2state), None, 0)
    s2st.optimizer = trainer.make_optimizer(_s2_cfg(port_config), s2st.model)
    one_s2 = (_sgd_step(s2st, _tb(s2batch)),
              {k: v.detach().clone()
               for k, v in s2st.model.named_parameters()})
    one_s2_start = {k: v for k, v in s2state.items() if k in one_s2[1]}
    cli_log = wait()
    outs = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    yield dict(d=d, outs=outs, mllm=mllm_state, jax_pp=jax_pp,
               jax_loss=jax_loss, jax_step=jax_step, jax_s2=jax_s2,
               one_loss=one_loss, one_step=one_step, one_sgd=one_sgd,
               one_s2=one_s2,
               one_s2_start=one_s2_start, cli_log=cli_log)
    torch.set_num_threads(prev)


def _assert_close_states(got, ref, rtol, atol):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# Pure functions
# ---------------------------------------------------------------------------

def test_split_join_round_trip():
    """A split is a filter by layer index and a join the union: the state
    comes back bit for bit; a stage's share is the outer part and its
    layers, under their global names."""
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    m = init_params(MultiModalLLM(_llama(port_config), _qformer(port_config)),
                    torch.Generator().manual_seed(0))
    state = m.state_dict()
    outer, layers = P.split_llama_layers(state, 2)
    assert not any(P.layer_index(k) is not None for k in outer)
    assert {P.layer_index(k) for k in layers[1]} == {2, 3}
    back = P.join_llama_layers(outer, layers)
    assert set(back) == set(state)
    assert all(back[k] is state[k] for k in state)
    share = P.stage_state(state, 2, 1)
    assert set(share) == set(outer) | set(layers[1])
    with pytest.raises(ValueError, match="must divide into 3"):
        P.split_llama_layers(state, 3)


def test_transfer_rule_goes_direct_under_nccl_and_for_cpu_tensors(
        monkeypatch):
    """``parallel.mesh``'s transfer rule: a CUDA tensor goes directly under
    NCCL and a CPU tensor under gloo, each counted by its kind; only a
    CUDA tensor under gloo is staged (on the card:
    ``tests/test_torch_cuda_kernel.py::test_staged_send_gloo_on_cuda``)."""
    class CudaStandIn:
        is_cuda = True
    M.reset_counts()
    monkeypatch.setattr(M.dist, "get_backend", lambda group=None: "nccl")
    assert M._staged(CudaStandIn(), None, "send") is None
    monkeypatch.setattr(M.dist, "get_backend", lambda group=None: "gloo")
    assert M._staged(torch.zeros(3), None, "recv") is None
    assert dict(M.COUNTS) == {"send": 1, "recv": 1}
    M.reset_counts()


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------

def test_pipeline_mesh_layout(ranks):
    """Data outer, pipe inner: rank r is stage r % pp of data rank
    r // pp; pp not dividing the world raises."""
    for r, o in enumerate(ranks["outs"]):
        assert o["layout"] == [(2, 2, r // 2, r % 2, [r - r % 2,
                                                      r - r % 2 + 1]),
                               (1, 4, 0, r, [0, 1, 2, 3])]
        assert "pipeline_parallel=3 must divide the world size 4" in \
            o["errors"]["pp3"]


@pytest.mark.parametrize("key", sorted(LOSSES))
def test_pipelined_loss_matches_jax_and_one_process(ranks, key):
    """The pipelined LM loss, the same on every rank, within rtol 2e-5 of
    the JAX package's (pipelined at pp 2 x dp 2, else one device) and of
    the port's one process."""
    pp, _, chunk = LOSSES[key]
    jax_ref = ranks["jax_pp"] if key == "pp2_dp2_m2" else ranks["jax_loss"]
    got = {o[f"loss_{key}"] for o in ranks["outs"]}
    assert len(got) == 1
    (loss,) = got
    np.testing.assert_allclose(loss, jax_ref, rtol=2e-5)
    np.testing.assert_allclose(loss, ranks["one_loss"][chunk], rtol=2e-5)


def test_pipeline_sends_on_the_cpu_are_direct(ranks):
    """CPU tensors in a gloo group go directly: the forward passes of the
    loss cases post one send a microbatch a boundary, none staged."""
    sends = {r: o["counts"].get("send", 0) for r, o in enumerate(
        ranks["outs"])}
    # stage 0 of pp 2 (ranks 0, 2) sends 2 microbatches; on pp 4 every
    # stage but the last sends 2 + 4 + 2
    assert sends == {0: 2 + 8, 1: 8, 2: 2 + 8, 3: 0}
    for o in ranks["outs"]:
        assert not any("staged" in k for k in o["counts"])


def test_pipelined_step_matches_jax_and_one_process(ranks):
    """One pipelined step (pp 2 x dp 2, 2 microbatches, AdamW lr 1e-2)
    against the JAX package's one-device stage-1 step and the port's
    one-process step: the loss within rtol 2e-5, every parameter of the
    joined state within ``tests/test_pipeline.py``'s tolerances; the base
    Llama did not move and LoRA did."""
    got = ranks["outs"][0]["step_params"]
    for o in ranks["outs"]:
        np.testing.assert_allclose(o["step_loss"], ranks["jax_step"][0],
                                   rtol=2e-5)
        np.testing.assert_allclose(o["step_loss"], ranks["one_step"][0],
                                   rtol=2e-5)
    for ref in (ranks["jax_step"][1], ranks["one_step"][1]):
        _assert_close_states(got, ref, 5e-3, 5e-4)
    start = ranks["mllm"]
    for k in got:
        if P.layer_index(k) is not None and "lora" not in k:
            assert torch.equal(got[k], start[k]), k
    moved = [k for k in got if k.endswith("lora_b")
             and not torch.equal(got[k], start[k])]
    assert len(moved) == 2 * 4


def test_pipelined_sgd_step_matches_one_process(ranks):
    """One pipelined step (pp 2 x dp 2, 2 microbatches) with clip + SGD at
    lr 1, whose update is the clipped gradient itself, against the port's
    one-process whole-batch step: the loss within rtol 1e-5, every
    parameter within 1e-5 of the largest update."""
    ref_loss, ref = ranks["one_sgd"]
    start = ranks["mllm"]
    got = ranks["outs"][0]["sgd_params"]
    for o in ranks["outs"]:
        assert o["sgd_loss"] == pytest.approx(ref_loss, rel=1e-5)
    assert set(got) == set(ref)
    scale = max(float((ref[k] - start[k]).abs().max()) for k in ref)
    assert scale > 0
    for k in ref:
        diff = float((ref[k] - got[k]).abs().max())
        assert diff <= 1e-5 * scale, (k, diff, scale)


def _float64_steps(monkeypatch, dtype):
    """One clip + SGD stage-1 step of the test's MLLM in ``dtype``, over
    the whole batch (``make_stage1_train_step``) and over its 4
    microbatches (``make_pipelined_stage1_step`` on a one-process mesh):
    {"whole" | "micro": (loss, update by name)}.  In float64 the model's
    fp32 promotions (``Tensor.float``) are kept at float64."""
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.models.tsue import init_params
    from tsue_tpu_torch.train import stage1
    from tsue_tpu_torch.train.trainer import TrainState
    from tsue_tpu_torch.utils.random import step_generator
    if dtype == torch.float64:
        to_float = torch.Tensor.float
        monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
            t if t.dtype == torch.float64 else to_float(t, *a, **k)))
    m = MultiModalLLM(_llama(port_config), _qformer(port_config), True,
                      dtype)
    init_params(m, torch.Generator().manual_seed(0))
    m.to(dtype)
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in _tb(_batch()).items()}
    st = TrainState(m, stage1.make_stage1_optimizer(
        _stage1_cfg(port_config), m), 0)
    st.optimizer.adamw = torch.optim.SGD(st.optimizer.params, lr=1.0,
                                         foreach=False)
    params = dict(m.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()
             if p.requires_grad}
    whole = stage1.make_stage1_train_step()
    micro, _ = P.make_pipelined_stage1_step(M.Mesh(device="cpu"), 4)
    out = {}
    for key, step in (("whole", lambda: whole(st, batch, step_generator(
            0, 0))), ("micro", lambda: micro(st, batch, 0, 0))):
        with torch.no_grad():
            for n, t in start.items():
                params[n].copy_(t)
        loss = float(step()["lm_loss"])
        out[key] = (loss, {n: (params[n].detach() - t).double()
                           for n, t in start.items()})
    return out


def test_microbatches_compute_the_whole_batch_step(monkeypatch):
    """The microbatch schedule is the whole batch's step, not an
    approximation of it: in float64 one clip + SGD step over 4
    microbatches equals the whole batch's to 1e-12 of the largest update
    and its loss to rel 1e-13.  In fp32 the two differ by rounding, which
    is printed beside each one's distance from the float64 step."""
    f64 = _float64_steps(monkeypatch, torch.float64)
    monkeypatch.undo()
    f32 = _float64_steps(monkeypatch, torch.float32)
    ref = f64["whole"][1]
    scale = max(float(u.abs().max()) for u in ref.values())
    assert scale > 0

    def diff(a, b):
        return max(float((a[n] - b[n]).abs().max()) for n in a) / scale
    assert f64["micro"][0] == pytest.approx(f64["whole"][0], rel=1e-13)
    assert diff(f64["micro"][1], ref) <= 1e-12
    print(f"float64: whole {f64['whole'][0]!r} micro {f64['micro'][0]!r}, "
          f"updates differ by {diff(f64['micro'][1], ref):.2e} of the "
          f"largest; fp32: whole against micro "
          f"{diff(f32['whole'][1], f32['micro'][1]):.2e}, whole against "
          f"float64 {diff(f32['whole'][1], ref):.2e}, micro against "
          f"float64 {diff(f32['micro'][1], ref):.2e}")


def test_pipelined_eval_step_deterministic(ranks):
    for o in ranks["outs"]:
        a, b = o["eval"]
        assert a == b
        np.testing.assert_allclose(a, ranks["one_loss"][0], rtol=2e-5)


def test_pipelined_dropout(ranks):
    """With dropout on: a repeated step from the same state and seeds is
    bit-identical and moves the weights; the same rows on both data ranks
    give different LoRA gradients (masks from each data rank's stream),
    the same ones at dropout 0."""
    outs = ranks["outs"]
    for o in outs:
        assert o["dropout_repeat"] and o["dropout_moved"]
    for r in (0, 1):       # stage r of data rank 0 and of data rank 1
        a, b = outs[r], outs[r + 2]
        assert torch.equal(a["lora_grad_0.0"], b["lora_grad_0.0"])
        assert a["lora_grad_0.1"].abs().max() > 0
        assert not torch.equal(a["lora_grad_0.1"], b["lora_grad_0.1"])


def test_pipeline_errors(ranks):
    """A data rank's rows the microbatches do not divide, and a batch the
    data axis does not divide, raise before any transfer."""
    for o in ranks["outs"]:
        assert "divisible by the microbatches 3" in o["errors"]["micro"]
        assert "divisible by the data-parallel degree 2" in \
            o["errors"]["batch"]


def test_tp2_dp2_stage2_step(ranks):
    """A TP 2 x DP 2 stage-2 step (clip + SGD) against one process and the
    JAX package's 2 x 2 mesh: the loss within rtol 1e-5, every update
    within 1e-5 of the largest (``tests/test_torch_parallel.py``)."""
    start = ranks["one_s2_start"]
    got = {k: v.float() for k, v in ranks["outs"][0]["tp_params"].items()}
    for ref_loss, ref in (ranks["one_s2"], ranks["jax_s2"]):
        for o in ranks["outs"]:
            assert o["tp_loss"] == pytest.approx(ref_loss, rel=1e-5)
        assert set(got) == set(ref)
        scale = max(float((ref[k] - start[k]).abs().max()) for k in ref)
        assert scale > 0
        for k in ref:
            diff = float((ref[k].detach() - got[k]).abs().max())
            assert diff <= 1e-5 * scale + 1e-8, (k, diff, scale)


def _same(x, y):
    if isinstance(x, torch.Tensor):
        return isinstance(y, torch.Tensor) and torch.equal(x, y)
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return x == y


@pytest.mark.parametrize("key", ["tp", "fsdp"])
def test_sharded_run_stage2_resumes_bit_for_bit(ranks, key):
    """``run_stage2`` under TP 2 x DP 2, or FSDP over DP 4: one epoch with
    a train state, then ``resume=True`` to two, gives the straight
    two-epoch run's metrics and train state bit for bit."""
    d = os.path.join(ranks["d"], key)
    for o in ranks["outs"]:
        assert o[f"{key}_resumed"] == o[f"{key}_straight"]
    assert ranks["outs"][0][f"{key}_straight"] == \
        ranks["outs"][3][f"{key}_straight"]
    a, b = _state_file(os.path.join(d, "a")), _state_file(os.path.join(d, "b"))
    assert a["epoch"] == b["epoch"] == 2
    assert _same(a, b)


@pytest.mark.parametrize("key", ["tp", "fsdp"])
def test_train_state_file_is_the_same_whatever_the_mesh(ranks, key,
                                                        tmp_path):
    """A train state written by the ranks restores in one process, and one
    written by one process restores under the mesh: restored and saved
    again, each is the file it was, bit for bit; the ranks' file resumes
    ``run_stage2`` in one process."""
    from tsue_tpu_torch.runner import run_stage2
    from tsue_tpu_torch.train.checkpoint import STATE_FILE
    d = ranks["d"]

    def load(p):
        return torch.load(os.path.join(p, STATE_FILE), weights_only=True)
    one = os.path.join(d, "one", "torch_pipeline_s2", "ckpt", "state")
    assert _same(load(os.path.join(d, key, "from_one")), load(one))
    ranks_file = os.path.join(d, key, "epoch1", "state")
    _resave(None, ranks_file, str(tmp_path / "again"))
    assert _same(load(str(tmp_path / "again")), load(ranks_file))
    shutil.copytree(os.path.join(d, key, "epoch1"),
                    tmp_path / "resume" / "torch_pipeline_s2" / "ckpt")
    out = run_stage2(_s2_cfg(port_config), out_dir=str(tmp_path / "resume"),
                     epochs=2, resume=True, synthetic_tracks=S2_TRACKS,
                     device="cpu")
    assert np.isfinite(out["test_ade"])


def test_stage1_cli_under_torchrun(ranks):
    """``stage1 --pipeline-parallel 2 --microbatches 2`` on two CPU ranks:
    the export is the one-process tree (``import_mllm`` reads it strictly
    into a one-process MLLM) and the generation dump is written once."""
    from tsue_tpu_torch.cli._common import apply_overrides, base_parser
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.train.checkpoint import STATE_FILE, import_mllm
    d = ranks["d"]
    assert "pipeline: pp=2 dp=1 microbatches=2" in ranks["cli_log"]
    cfg = apply_overrides(get_preset("train_18_30"),
                          base_parser("").parse_args(["--tiny"]))
    llama = dataclasses.replace(cfg.model.llama,
                                vocab_size=ByteTokenizer().vocab_size)
    one = MultiModalLLM(llama, cfg.model.qformer, cfg.model.use_vision)
    stored = torch.load(os.path.join(d, "cli_export", STATE_FILE),
                        weights_only=True)
    assert {k: tuple(v.shape) for k, v in stored.items()} == \
        {k: tuple(v.shape) for k, v in one.state_dict().items()}
    import_mllm(one, os.path.join(d, "cli_export"))
    dump = os.path.join(d, "cli", "stage1_train_18_30",
                        "test_generation_results.txt")
    with open(dump) as f:
        text = f.read()
    assert text.count("GENERATED:") > 0


if __name__ == "__main__":
    _worker(sys.argv[1])
