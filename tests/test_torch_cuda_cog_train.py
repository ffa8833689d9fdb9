"""The CogVideoX training path on the card: K6 at the CogVideoX training
length (19,126 tokens, head_dim 64) against its plain version, and one
train step of a full-width CogVideoX block against the same step in fp32
on the CPU. Every test needs an NVIDIA GPU and skips without one; run them
on a GPU machine with ``python -m pytest --noconftest
tests/test_torch_cuda_cog_train.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from frameino_tpu_torch.models import cogvideox_dit as cdit
from frameino_tpu_torch.ops import attention as A
from frameino_tpu_torch.training import cog_trainer

pytestmark = pytest.mark.cuda

# K6's limits in chip_smoke.py: the forward's and the gradients' relative L2
FLASH_REL_L2, GRAD_REL_L2 = 5e-3, 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def test_k6_at_the_cogvideox_training_length(dev):
    """2 heads of [19126, 64] (226 text + 14 x 30 x 45 video tokens; the
    last 64-row tile holds 54 rows): o and dQ, dK, dV against the plain
    version's fp32 autograd, the last partial tile on its own."""
    g = torch.Generator(dev).manual_seed(0)
    s, d = 19126, 64
    q, k, v, do = (torch.randn(1, 2, s, d, device=dev, dtype=torch.bfloat16,
                               generator=g) for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = A.flash_attention_train(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.float().requires_grad_() for t in (q, k, v)]
    ref = A.flash_attention_train_ref(*ref_leaves)
    want = torch.autograd.grad(ref, ref_leaves, do.float())
    assert _rel_l2(out, ref) <= FLASH_REL_L2
    tail = s // 64 * 64
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) <= GRAD_REL_L2
        assert _rel_l2(a[:, :, tail:], b[:, :, tail:]) <= GRAD_REL_L2


def test_full_width_block_step_matches_fp32_on_the_cpu(dev):
    """One CogVideoX-5B block at full width (48 heads of 64), Stage 2,
    remat, on a 2 x 8 x 8 latent grid with a full 226-token prompt: the
    card's bf16 loss and parameter gradients against fp32 on the CPU on the
    same weights and draws, within twice what bf16 moves them on the CPU;
    exactly 2 K6 forwards and 1 backward."""
    cfg = dataclasses.replace(cdit.COGVIDEOX_5B_I2V_FRAMEINO, num_layers=1)
    m16 = cdit.init_cogvideox_dit(cfg, torch.Generator().manual_seed(7),
                                  dtype=torch.bfloat16)
    sd = m16.state_dict()
    rs = np.random.RandomState(3)

    def arr(*shape):
        return torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    lat = (arr(1, 2, 16, 8, 8), torch.cat([arr(1, 1, 16, 8, 8),
                                           torch.zeros(1, 1, 16, 8, 8)], 1),
           arr(1, 2, 16, 8, 8), arr(1, 1, 16, 8, 8))
    text = arr(1, 226, 4096)
    draws = {"t": torch.tensor([412]), "noise": arr(1, 2, 16, 8, 8)}
    got = {}
    for tag, device, dtype in (("fp32", "cpu", torch.float32),
                               ("cpu16", "cpu", torch.bfloat16),
                               ("card", dev, torch.bfloat16)):
        m = cdit.CogVideoXDiT(cfg, device="meta", dtype=dtype)
        m.load_state_dict({k: v.to(device, dtype) for k, v in sd.items()},
                          assign=True)
        m.train()
        params = dict(m.named_parameters())
        tcfg = cog_trainer.CogTrainerConfig(compute_dtype=dtype, remat=True)
        A.reset_launch_counts()
        loss = cog_trainer.cog_vpred_loss(
            m, tcfg, *(t.to(device) for t in lat), text.to(device),
            cog_trainer.CogDraws(given=draws))
        grads = torch.autograd.grad(loss, list(params.values()))
        got[tag] = (loss.item(), {n: g.float().cpu()
                                  for n, g in zip(params, grads)})
        if tag == "card":
            counts = A.launch_counts()
    assert counts["flash_attn_train_fwd"] == 2
    assert counts["flash_attn_train_bwd"] == 1
    loss32, g32 = got["fp32"]

    def err(tag):
        loss, gs = got[tag]
        num = sum(float((gs[n] - g32[n]).norm() ** 2) for n in g32)
        den = sum(float(g.norm() ** 2) for g in g32.values())
        return abs(loss - loss32) / abs(loss32), (num / den) ** 0.5
    card, cpu16 = err("card"), err("cpu16")
    assert all(np.isfinite(g.sum()) for g in got["card"][1].values())
    assert card[0] <= 2 * cpu16[0] + 1e-3, (card, cpu16)
    assert card[1] <= 2 * cpu16[1], (card, cpu16)
