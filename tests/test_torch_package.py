"""Package-level properties of the port: no JAX and nothing of the JAX
package, a strict weight bridge, the CUDA device by default (serving, the
continuous batcher, the CLI, stage-1 and stage-2 training), no kernel launch on CPU tensors, no decode
kernel (nor the ADE/FDE kernel) under autograd, and the options not ported
yet raising."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tsue_tpu.models.lane_encoder import LanePolygonEncoder as JaxLane
from tsue_tpu_torch.convert import load_flax_params
from tsue_tpu_torch.models.lane_encoder import LanePolygonEncoder
from tsue_tpu_torch.ops.attention import dot_product_attention
from tsue_tpu_torch.ops.flash import flash_attention
from tsue_tpu_torch.ops.fused import fused_rmsnorm, swiglu_matmul
from tsue_tpu_torch.ops.kv_quant import attend_int8_kv, quantize_kv
from tsue_tpu_torch.ops.lmhead_topk import lmhead_topk
from tsue_tpu_torch.ops.lora import lora_matmul
from tsue_tpu_torch.ops.metric_kernels import fused_ade_fde
from tsue_tpu_torch.ops.nlinear import nlinear_fused
from tsue_tpu_torch.ops.quant import int8_matmul, quantize_weight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PORT_MODULES = (
    "tsue_tpu_torch", "tsue_tpu_torch.config", "tsue_tpu_torch.data",
    "tsue_tpu_torch.serve", "tsue_tpu_torch.convert",
    "tsue_tpu_torch.eval.generation", "tsue_tpu_torch.eval.speculative",
    "tsue_tpu_torch.ops.sampling",
    "tsue_tpu_torch.ops.quant", "tsue_tpu_torch.ops.kv_quant",
    "tsue_tpu_torch.ops.lmhead_topk", "tsue_tpu_torch.ops.fused",
    "tsue_tpu_torch.data.dataset", "tsue_tpu_torch.utils.logging",
    "tsue_tpu_torch.train.trainer", "tsue_tpu_torch.train.stage1",
    "tsue_tpu_torch.train.checkpoint", "tsue_tpu_torch.ops.nlinear",
    "tsue_tpu_torch.ops.lora", "tsue_tpu_torch.ops.metric_kernels",
    "tsue_tpu_torch.runner", "tsue_tpu_torch.serve_batching",
    "tsue_tpu_torch.cli", "tsue_tpu_torch.cli.__main__",
    "tsue_tpu_torch.cli._common", "tsue_tpu_torch.cli.train",
    "tsue_tpu_torch.cli.stage1", "tsue_tpu_torch.cli.test",
    "tsue_tpu_torch.cli.serve", "tsue_tpu_torch.cli.baseline",
    "tsue_tpu_torch.cli.diffusion", "tsue_tpu_torch.models.baselines",
    "tsue_tpu_torch.models.baselines.cv",
    "tsue_tpu_torch.models.baselines.lstm",
    "tsue_tpu_torch.models.baselines.stgcnn",
    "tsue_tpu_torch.models.baselines.trajectron",
    "tsue_tpu_torch.models.baselines.mmtrans",
    "tsue_tpu_torch.models.baselines.gail",
    "tsue_tpu_torch.models.diffusion",
    "tsue_tpu_torch.train.baseline_steps", "chip_smoke", "flash_variants",
    "head_variants", "lora_variants", "swiglu_variants", "nlinear_variants")


def test_port_imports_no_jax():
    """The port, chip_smoke.py and the kernels' variant scripts
    (flash_variants.py, head_variants.py, lora_variants.py,
    swiglu_variants.py, nlinear_variants.py) import neither JAX nor any module of the JAX
    package (``tsue_tpu``, ``tsue_tpu.*``)."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tsue_tpu')]\n"
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_predictor_defaults_to_cuda():
    """Without ``device=`` the Predictor wants the CUDA device; on a host
    without one it raises instead of running on the CPU."""
    from tsue_tpu_torch.config import (DataConfig, ExperimentConfig,
                                       LaneEncoderConfig, LTSFConfig,
                                       ModelConfig)
    from tsue_tpu_torch.models.tsue import TrajectoryModel
    from tsue_tpu_torch.serve import Predictor
    import inspect
    assert inspect.signature(Predictor).parameters["device"].default == \
        "cuda"
    cfg = ExperimentConfig(
        name="device", data=DataConfig(seq_len=6, out_len=6, use_text=False,
                                       use_vision=False),
        model=ModelConfig(use_llm=False,
                          lane=LaneEncoderConfig(d_model=16, nhead=2,
                                                 num_layers=1),
                          ltsf=LTSFConfig(d_model=16, polygon_embed_dim=16)))
    state = TrajectoryModel(cfg.model, 6, 6).state_dict()
    if torch.cuda.is_available():
        assert Predictor(cfg, state).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor(cfg, state)
    assert Predictor(cfg, state, device="cpu").device.type == "cpu"


def test_batcher_and_serve_cli_default_to_cuda():
    """The continuous batcher and every command of the CLI want the CUDA
    device unless given the CPU; on a host without one they raise instead
    of running on the CPU."""
    import inspect
    from tsue_tpu_torch.cli import serve
    from tsue_tpu_torch.cli._common import base_parser
    from tsue_tpu_torch.config import LlamaConfig, QFormerConfig
    from tsue_tpu_torch.models.fusion import MultiModalLLM
    from tsue_tpu_torch.ops.sampling import SamplingConfig
    from tsue_tpu_torch.serve_batching import ContinuousBatcher
    assert inspect.signature(ContinuousBatcher).parameters[
        "device"].default == "cuda"
    assert base_parser("t").parse_args([]).device == "cuda"
    assert serve.parser().parse_args([]).device == "cuda"
    mllm = MultiModalLLM(LlamaConfig.tiny(), QFormerConfig(
        num_encoder_layers=1, num_decoder_layers=1, num_query_tokens=4))
    kw = dict(num_slots=2, prompt_len=4, max_new_tokens=4, eos_id=1)
    assert ContinuousBatcher(mllm, SamplingConfig(), device="cpu",
                             **kw).device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(mllm, SamplingConfig(), **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--tiny"])


@pytest.fixture(scope="module")
def lane_params():
    poly = jnp.zeros((1, 8, 2))
    plen = jnp.array([3], jnp.int32)
    variables = jax.jit(JaxLane(d_model=8, num_heads=2, num_layers=1).init)(
        jax.random.key(0), poly, plen)
    return traverse_util.flatten_dict(jax.device_get(variables["params"]))


def _port():
    return LanePolygonEncoder(d_model=8, num_heads=2, num_layers=1)


def test_converter_fills_every_parameter(lane_params):
    port = load_flax_params(_port(), traverse_util.unflatten_dict(lane_params))
    q = lane_params[("block_0", "MHA_0", "q", "kernel")]           # (D, H, Dh)
    np.testing.assert_array_equal(port.block_0.MHA_0.q.weight.detach().numpy(),
                                  q.reshape(8, 8).T)
    o = lane_params[("block_0", "MHA_0", "o", "kernel")]           # (H, Dh, D)
    np.testing.assert_array_equal(port.block_0.MHA_0.o.weight.detach().numpy(),
                                  o.reshape(8, 8).T)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_is_strict(lane_params, fault):
    flat = dict(lane_params)
    if fault == "missing":
        del flat[("block_0", "LayerNorm_1", "bias")]
        err = KeyError
    elif fault == "extra":
        flat[("block_0", "MHA_0", "q", "lora_a")] = np.zeros((8, 2),
                                                            np.float32)
        err = KeyError
    else:
        flat[("input_proj", "kernel")] = np.zeros((3, 8), np.float32)
        err = ValueError
    with pytest.raises(err):
        load_flax_params(_port(), traverse_util.unflatten_dict(flat))


def _kernel_inputs(device="cpu"):
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(device)
    q, k, v = t((1, 5, 2, 16)), t((1, 5, 2, 16)), t((1, 5, 2, 16))
    w8, scale = quantize_weight(t((16, 8)))
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    head = quantize_weight(t((128, 16)), axis=1)
    return dict(q=q, k=k, v=v, w8=w8, scale=scale,
                cache=(k8, ks, v8, vs), head=head,
                hidden=t((2, 16)), emb=t((128, 16)), rows=t((130, 128)))


def test_cpu_tensors_never_launch_the_kernels():
    x = _kernel_inputs()
    counters = (flash_attention, int8_matmul, attend_int8_kv, lmhead_topk,
                fused_rmsnorm, swiglu_matmul, nlinear_fused, lora_matmul,
                fused_ade_fde)
    before = [f.launches for f in counters]
    nlinear_fused(x["q"][0], torch.zeros(2, 16, 3), torch.zeros(2, 3))
    lora_matmul(x["hidden"], x["emb"][:16], x["emb"][:16, :4],
                x["emb"][:4], 4.0)
    fused_ade_fde(x["q"][0, :, :2], x["k"][0, :, :2], x["emb"][:5, :4])
    fused_rmsnorm(x["rows"], torch.ones(128))
    swiglu_matmul(x["rows"], x["rows"], x["rows"][:128])
    flash_attention(x["q"], x["k"], x["v"], is_causal=True)
    dot_product_attention(x["q"], x["k"], x["v"],
                          torch.ones(1, 5, dtype=torch.int32))
    int8_matmul(x["q"], x["w8"], x["scale"])
    attend_int8_kv(x["q"][:, :1], x["cache"], torch.ones(1, 5))
    lmhead_topk(x["hidden"], x["emb"], None)
    w8, s = x["head"]
    lmhead_topk(x["hidden"], None, None, quant=(w8.t().contiguous(), s))
    assert [f.launches for f in counters] == before == [0] * 9


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain-version fallback, from any of the four wrappers."""
    q = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no int8 kernel"):
        int8_matmul(q, torch.empty(16, 8, dtype=torch.int8),
                    torch.ones(8))
    with pytest.raises(ValueError, match="no int8 attention kernel"):
        attend_int8_kv(q, (None, None, None, None), None)
    with pytest.raises(ValueError, match="no head kernel"):
        lmhead_topk(q[0, 0], q[0, 0], None)
    rows = torch.empty(128, 128, device="meta")
    with pytest.raises(ValueError, match="no rmsnorm kernel"):
        fused_rmsnorm(rows, rows[0])
    with pytest.raises(ValueError, match="no swiglu kernel"):
        swiglu_matmul(rows, rows, rows)
    with pytest.raises(ValueError, match="no nlinear kernel"):
        nlinear_fused(q[0], q[0], q[0, 0])
    with pytest.raises(ValueError, match="no lora kernel"):
        lora_matmul(rows, rows, rows[:, :4], rows[:4], 1.0)
    with pytest.raises(ValueError, match="no ade/fde kernel"):
        fused_ade_fde(q[:, :2], q[:, :2], rows[:4, :4])


def test_shared_wrapper_contract():
    """The checks every kernel wrapper shares: a tensor of another device,
    dtype, shape or layout raises before a launch; a launch that returns a
    CUDA error raises and is not counted, one that succeeds is."""
    from tsue_tpu_torch.ops._build import (check_tensor, count_launch,
                                           uses_kernel)
    cpu = torch.device("cpu")
    t = torch.zeros(4, 8)
    check_tensor("t", t, cpu, (4, 8), torch.float32, aligned=True)
    with pytest.raises(TypeError):
        check_tensor("t", t, cpu, (4, 8), torch.int8)
    with pytest.raises(ValueError, match="shape"):
        check_tensor("t", t, cpu, (8, 4), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        check_tensor("t", t.t(), cpu, (8, 4), torch.float32)
    with pytest.raises(ValueError, match="16-byte"):
        check_tensor("t", t.reshape(-1)[1:], cpu, (31,), torch.float32,
                     aligned=True)
    with pytest.raises(ValueError, match="is on meta"):
        check_tensor("t", t.to("meta"), cpu, (4, 8), torch.float32)
    assert not uses_kernel(t, "test kernel")
    with pytest.raises(ValueError, match="no test kernel for device meta"):
        uses_kernel(t.to("meta"), "test kernel")

    def wrapper():
        pass
    wrapper.launches = 0
    with pytest.raises(RuntimeError, match="wrapper launch failed"):
        count_launch(wrapper, 700)
    count_launch(wrapper, 0)
    assert wrapper.launches == 1


def test_refuse_grad_contract():
    """The shared rule of the decode kernels, which have no backward: under
    grad mode an input that requires a gradient raises; under no_grad, or
    with no such input, the call goes on."""
    from tsue_tpu_torch.ops._build import refuse_grad
    t = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        refuse_grad("test kernel", None, torch.zeros(2), t)
    refuse_grad("test kernel", torch.zeros(2), None)
    with torch.no_grad():
        refuse_grad("test kernel", t)
    with torch.inference_mode():
        refuse_grad("test kernel", t)


def test_decode_wrappers_raise_under_grad_on_cuda(monkeypatch):
    """Each decode wrapper applies the rule on its kernel's path, before
    any launch (the path is taken here by pretending the tensors are on
    the card)."""
    from tsue_tpu_torch.ops import kv_quant, lmhead_topk as lt, quant
    x = _kernel_inputs()
    for mod in (quant, lt, kv_quant):
        monkeypatch.setattr(mod, "uses_kernel", lambda t, what: True)
    q = x["q"].requires_grad_()
    with pytest.raises(RuntimeError, match="int8_matmul has no backward"):
        int8_matmul(q, x["w8"], x["scale"])
    with pytest.raises(RuntimeError, match="attend_int8_kv has no backward"):
        attend_int8_kv(q[:, :1], x["cache"], None)
    w8, s = x["head"]
    with pytest.raises(RuntimeError, match="lmhead_topk has no backward"):
        lmhead_topk(x["hidden"], None, None,
                    quant=(w8.t().contiguous(), s.requires_grad_()))
    assert int8_matmul.launches == attend_int8_kv.launches == \
        lmhead_topk.launches == 0


def test_ade_fde_wrapper_raises_under_grad_on_cuda(monkeypatch):
    """The ADE/FDE kernel has no backward (the JAX kernel has no VJP):
    under grad mode its kernel path raises before any launch, as the
    decode wrappers do; the two kernels with a backward (NLinear, LoRA)
    are autograd Functions instead."""
    from tsue_tpu_torch.ops import metric_kernels
    monkeypatch.setattr(metric_kernels, "uses_kernel", lambda t, what: True)
    pred = torch.rand(2, 2, 5, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_ade_fde has no backward"):
        fused_ade_fde(pred, pred.detach(), torch.ones(2, 4))
    assert fused_ade_fde.launches == 0


def test_training_defaults_to_cuda():
    """``run_stage1``, ``run_stage2`` and the model stage 2 trains want the
    CUDA device unless given ``device="cpu"``; without one they raise
    instead of running on the CPU."""
    import inspect
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.data import ByteTokenizer
    from tsue_tpu_torch.runner import (build_model_and_params, run_stage1,
                                       run_stage2)
    for fn in (run_stage1, run_stage2, build_model_and_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_preset("train_18_30")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stage2(cfg, epochs=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_stage1(cfg, epochs=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model_and_params(cfg, ByteTokenizer())


@pytest.mark.parametrize("option", ["stage1_pipeline"])
def test_options_not_ported_yet_raise(option, tmp_path):
    """What the runners do not take yet raises NotImplementedError before
    any work: stage 1's pipeline parallelism.  (Taken since: ``mllm_ckpt``
    with stage 1; ``restore_ckpt``, ``save_every`` and ``resume`` with
    checkpoints on disk; ``viz_every``, ``save_viz``, remat and bfloat16
    with the rest of training, tested in ``test_torch_viz.py``,
    ``test_torch_remat.py`` and ``test_torch_bf16.py``.)"""
    import dataclasses
    from tsue_tpu_torch.config import get_preset
    from tsue_tpu_torch.runner import run_stage1
    cfg = get_preset("train_18_30")
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, pipeline_parallel=2))
    with pytest.raises(NotImplementedError):
        run_stage1(cfg, out_dir=str(tmp_path), epochs=0, device="cpu")
