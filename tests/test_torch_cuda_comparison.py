"""The flash kernel at the comparison models' attention shapes, on the card:
MMTrans's self-attention (B 16, 6 trajectory steps + 64 lane points, 8
heads of 16, a key mask over the zero lane points) and the DDPM UNet's
bottleneck cross-attention (1 head of 64, 18 queries over one key: a 64-key
tile with 63 dead keys), with the edges around them (one key under every
head width the kernel takes, more than 16 items so the tiled form runs;
masks that leave the one key or nothing), and the models' forwards on the
card against the CPU.

These tests need a CUDA device and skip without one.  The machine with the
card has no JAX, which ``tests/conftest.py`` imports, so run them there
without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_comparison.py -q

Tolerance atol = rtol = 1e-4 against the plain version, both fp32.
"""
import copy
import itertools

import pytest
import torch

from tsue_tpu_torch.ops.flash import (SUPPORTED_HEAD_DIMS, flash_attention,
                                      flash_attention_form,
                                      flash_attention_plain)

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def _check(q, k, v, mask=None):
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL)
    return out


@pytest.mark.parametrize("B", [10, 32])
def test_ddpm_cross_attention_one_key(dev, B):
    """The UNet's cross-attention in sampling (B 10) and training (B 32):
    the tiled form, every output row equal to the one value row, and a
    repeated call bit-identical."""
    g = torch.Generator(device=dev).manual_seed(B)
    q = torch.randn(B, 18, 1, 64, generator=g, device=dev)
    k, v = (torch.randn(B, 1, 1, 64, generator=g, device=dev)
            for _ in range(2))
    assert flash_attention_form(B, 18, 1, 1, 1, 64, False, False,
                                torch.float32, torch.float32) == "tiled"
    out = _check(q, k, v)
    torch.testing.assert_close(out, v.expand_as(out), **TOL)
    assert torch.equal(out, flash_attention(q, k, v))


@pytest.mark.parametrize("D", SUPPORTED_HEAD_DIMS)
def test_one_key_edges(dev, D):
    """One key at every head width, GQA 1..8, 17 to 130 items (the tiled
    form; D = 1024 the split-KV one), with no mask, a mask keeping the key
    and one dropping it on some rows (a uniform average over no valid key:
    the value row)."""
    g = torch.Generator(device=dev).manual_seed(D)
    for (Hq, Hkv), Tq, masked in itertools.product(
            ((1, 1), (4, 2), (8, 1)), (17, 18, 70, 130), (None, "keep",
                                                          "drop")):
        q = torch.randn(3, Tq, Hq, D, generator=g, device=dev)
        k, v = (torch.randn(3, 1, Hkv, D, generator=g, device=dev)
                for _ in range(2))
        mask = None
        if masked:
            mask = torch.ones(3, 1, dtype=torch.int32, device=dev)
            if masked == "drop":
                mask[1] = 0
        _check(q, k, v, mask)


@pytest.mark.parametrize("lens", [[0] * 16, [64] * 16,
                                  [0, 5, 64, 0, 12, 30, 0, 64, 1, 2, 40, 0,
                                   64, 7, 9, 0]])
def test_mmtrans_self_attention(dev, lens):
    """MMTrans's self-attention: 6 trajectory keys always valid, then the
    first ``lens[b]`` of 64 lane points."""
    g = torch.Generator(device=dev).manual_seed(sum(lens))
    q, k, v = (torch.randn(16, 70, 8, 16, generator=g, device=dev)
               for _ in range(3))
    valid = 6 + torch.tensor(lens, device=dev)
    mask = (torch.arange(70, device=dev)[None] < valid[:, None]).int()
    _check(q, k, v, mask)


def test_comparison_models_on_the_card(dev):
    """MMTrans's deterministic forward (4 kernel launches) and the UNet's
    CFG forward (1 launch) on the card against the CPU, same weights, at
    the models' own widths."""
    from tsue_tpu_torch.models.baselines import MMTrans
    from tsue_tpu_torch.models.diffusion import ConditionalUNet
    from tsue_tpu_torch.models.tsue import init_params
    g = torch.Generator().manual_seed(0)
    span = torch.rand(16, 2, generator=g) * 400 + 50
    lo = torch.rand(16, 2, generator=g) * 3000
    batch = {"traj_in": torch.rand(16, 2, 6, generator=g),
             "polygon": lo[:, None] + torch.rand(16, 64, 2, generator=g)
             * span[:, None],
             "polygon_len": torch.randint(0, 65, (16,), generator=g),
             "norm_stat": torch.stack([lo[:, 0], lo[:, 0] + span[:, 0],
                                       lo[:, 1], lo[:, 1] + span[:, 1]], 1)}
    for model, args, launches in (
            (MMTrans(6, 30), (batch,), 4),
            (ConditionalUNet(), (torch.randn(10, 2, 18, generator=g),
                                 torch.randn(10, 128, generator=g)), 1)):
        init_params(model, torch.Generator().manual_seed(1))
        with torch.no_grad():
            ref = model(*args)
            card = copy.deepcopy(model).to(dev)
            before = flash_attention.launches
            out = card(*[{k: t.to(dev) for k, t in a.items()}
                         if isinstance(a, dict) else a.to(dev)
                         for a in args])
        assert flash_attention.launches == before + launches
        torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=1e-4)
