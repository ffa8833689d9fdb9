"""The port's dp x tp serving slice on the CPU: the sharded attention, DiT
and pipeline in 2 and 4 gloo processes against JAX's sharded functions on
the conftest's 8 virtual devices (interpret-mode Pallas inside JAX's
shard_map) and against the port's unsharded pipeline; the sharding rules
against JAX's ``dit_param_specs``; and what is not ported raising.

The workers (``tests/_torch_parallel_worker.py``) import no jax; inputs
and weights are made here with numpy or by JAX and handed to them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from frameino_tpu.core.meshes import MeshConfig as JMeshConfig
from frameino_tpu.core.meshes import make_mesh as jmake_mesh
from frameino_tpu.models import cogvideox_dit as jcdit
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.ops import attention as jattn
from frameino_tpu.parallel import sharding as jsharding
from frameino_tpu_torch import serve
from frameino_tpu_torch.core.meshes import Mesh, MeshConfig
from frameino_tpu_torch.models import cogvideox_dit as tcdit
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import (cogvideox_dit_from_jax,
                                               wan_dit_from_jax)
from frameino_tpu_torch.parallel.sharding import shard_state_dict, tp_dim
from frameino_tpu_torch.pipelines import wan_i2v as tpipe

MESHES = [dict(tp=2), dict(tp=4), dict(dp=2, tp=2)]
# the tiny DiT with heads enough for tp = 4
DIT_KW = dict(num_attention_heads=4, attention_head_dim=32, in_channels=8,
              out_channels=4)


def _ids(kw):
    return "x".join(f"{k}{v}" for k, v in kw.items())


def _jmesh(mesh_kw):
    cfg = JMeshConfig(**mesh_kw)
    return jmake_mesh(cfg, devices=jax.devices()[:cfg.size])


def _load(tmp_path, name, world):
    return [np.load(tmp_path / f"{name}_{r}.npy") for r in range(world)]


def _rope(S, D, seed):
    """Real RoPE tables (rotations) of S positions: with unit-normal
    cos/sin the per-shard static bound cuts K1's floor differently from
    the unsharded one."""
    ang = np.random.RandomState(seed).uniform(0, 2 * np.pi, (S, D // 2))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("mesh_kw", MESHES, ids=_ids)
def test_fused_sharded_attention_matches_jax(tmp_path, mesh_kw):
    """All-reduced statistic -> K5's plain version -> per-rank bound ->
    K1's plain version on every rank == JAX's shard_map of
    ``_qk_producer`` and ``_flash_fwd_static`` (interpret), fp32."""
    B, H, S, D, eps = 2, 4, 300, 32, 1e-6
    rs = np.random.RandomState(11)
    q_raw, k_raw = (rs.randn(B, S, H * D).astype(np.float32)
                    for _ in range(2))
    v = rs.randn(B, H, S, D).astype(np.float32)
    w_q, w_k = ((1 + 0.1 * rs.randn(H * D)).astype(np.float32)
                for _ in range(2))
    cos, sin = _rope(S, D, 12)
    mesh = _jmesh(mesh_kw)
    with mesh:
        ref = jax.jit(lambda *a: jattn.fused_qk_flash_attention_sharded(
            *a, mesh, num_heads=H, eps=eps, interpret=True))(
            q_raw, k_raw, v, w_q, w_k, cos, sin)
    ref = np.asarray(ref)
    world = MeshConfig(**mesh_kw).size
    W.spawn(W.attention, world, tmp_path, mesh_kw, q_raw, k_raw, v, w_q,
            w_k, cos, sin, H, eps)
    cfg = MeshConfig(**mesh_kw)
    bl, hl = B // cfg.dp, H // cfg.tp
    for r, out in enumerate(_load(tmp_path, "attn", world)):
        c = Mesh(cfg, r).coords
        want = ref[c["dp"] * bl:(c["dp"] + 1) * bl,
                   c["tp"] * hl:(c["tp"] + 1) * hl]
        # fp32 on both sides; sums in another order (2e-5, as JAX holds
        # its sharded path to its unsharded one)
        np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jax_dit():
    cfg = jdit.tiny_config(**DIT_KW)
    params = jdit.init_wan_dit(jax.random.key(3), cfg)
    rs = np.random.RandomState(4)
    B, F, Hh, Ww = 2, 3, 4, 6
    x = rs.randn(B, 8, F, Hh, Ww).astype(np.float32)
    t = np.array([999.0, 357.5], np.float32)
    ctx = rs.randn(B, 7, 16).astype(np.float32)
    S = F * (Hh // 2) * (Ww // 2)
    mask = np.ones((B, S), np.float32)
    mask[:, :S // F] = 0.0
    return cfg, params, (x, t, ctx, mask)


@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(dp=2, tp=2)],
                         ids=_ids)
def test_sharded_dit_matches_jax(tmp_path, jax_dit, mesh_kw):
    """The tiny DiT, sharded over the mesh from the bridged JAX tree, with
    the text K/V projected in the forward and hoisted, on every rank ==
    JAX's ``wan_dit_forward(attn_impl="pallas", mesh=)`` (fused sharded
    producers and the sharded K3 in interpret mode), fp32."""
    cfg, params, args = jax_dit
    mesh = _jmesh(mesh_kw)
    jattn.FORCE_INTERPRET = True
    try:
        with mesh:
            ref = jax.jit(lambda p, x, t, c, m: jdit.wan_dit_forward(
                cfg, p, x, t, c, timestep_mask=m, attn_impl="pallas",
                mesh=mesh))(params, *args)
    finally:
        jattn.FORCE_INTERPRET = False
    ref = np.asarray(ref)
    params_np = jax.tree.map(np.asarray, params)
    world = MeshConfig(**mesh_kw).size
    W.spawn(W.dit, world, tmp_path, mesh_kw, DIT_KW, params_np, *args)
    for name in ("dit", "dit_kv"):
        for out in _load(tmp_path, name, world):
            # fp32 through 2 blocks; reordered sums (1e-4, as the unsharded
            # DiT is held to JAX's)
            np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def _pipeline_inputs():
    rs = np.random.RandomState(7)
    H = W_ = 16
    image = np.tanh(rs.randn(1, 3, H, W_)).astype(np.float32)
    text = rs.randn(1, 7, 16).astype(np.float32)
    traj = np.tanh(rs.randn(1, 3, 9, H, W_)).astype(np.float32)
    ids = np.tanh(rs.randn(1, 3, 1, H, W_)).astype(np.float32)
    latents = rs.randn(1, 4, 5, H // 2, W_ // 2).astype(np.float32)
    kw = dict(height=H, width=W_, num_frames=9, num_inference_steps=2,
              guidance_scale=5.0)
    return (image, text, traj, ids, latents), kw


@pytest.fixture(scope="module")
def unsharded_video():
    _, vae_cfg = serve.smoke_configs()
    gen = torch.Generator().manual_seed(0)
    dit = tdit.init_wan_dit(tdit.tiny_config(**DIT_KW), gen)
    vae = tvae.init_wan_vae(vae_cfg, gen)
    inputs, kw = _pipeline_inputs()
    image, text, traj, ids, latents = (torch.from_numpy(a) for a in inputs)
    return tpipe.WanImageToVideoPipeline(dit, vae)(
        image, prompt_embeds=text, traj_tensor=traj, id_tensor=ids,
        latents=latents, **kw)


@pytest.mark.parametrize("mesh_kw", MESHES, ids=_ids)
def test_sharded_pipeline_matches_unsharded(tmp_path, unsharded_video,
                                            mesh_kw):
    """The tiny pipeline over the mesh (the DiT sliced from the same
    seeded init, the VAE on rank 0 only, 2 CFG steps) == the port's
    unsharded pipeline, fp32; only rank 0 returns the video."""
    _, vae_cfg = serve.smoke_configs()
    inputs, kw = _pipeline_inputs()
    W.spawn(W.pipeline, MeshConfig(**mesh_kw).size, tmp_path, mesh_kw,
            DIT_KW, vae_cfg, inputs, kw)
    got = np.load(tmp_path / "video_0.npy")
    assert not (tmp_path / "video_1.npy").exists()
    # fp32; the sharded sums and K1's static softmax reorder (1e-4)
    np.testing.assert_allclose(got, unsharded_video, atol=1e-4, rtol=1e-4)


def test_multihost_helpers(tmp_path):
    """broadcast_from_rank0, assert_same_across_processes and make_mesh's
    size check in 2 gloo processes."""
    W.spawn(W.multihost_helpers, 2, tmp_path)
    assert all(x.all() for x in _load(tmp_path, "diverged", 2))
    assert all(x.all() for x in _load(tmp_path, "bad_size", 2))


@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(dp=2, tp=4)],
                         ids=_ids)
def test_shard_state_dict_matches_dit_param_specs(jax_dit, mesh_kw):
    """Each rank's slice of the bridged tree == the bridge of the shards
    JAX's ``shard_pytree`` places on that rank's device, except the
    qk-norm gains, which JAX replicates (GSPMD slices them where they
    are used) and the port cuts to the rank's heads."""
    cfg, params, _ = jax_dit
    tcfg = tdit.tiny_config(**DIT_KW)
    jmesh = _jmesh(mesh_kw)
    placed = jsharding.shard_pytree(params, jmesh)
    full = wan_dit_from_jax(jax.tree.map(np.asarray, params), tcfg)
    mcfg = MeshConfig(**mesh_kw)
    for rank in range(mcfg.size):
        mesh = Mesh(mcfg, rank)
        c = mesh.coords
        dev = jmesh.devices[c["dp"], 0, c["tp"], 0, 0]
        local = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == dev), placed)
        want = wan_dit_from_jax(local, tcfg)
        got = shard_state_dict(full, mesh)
        assert got.keys() == want.keys()
        n_cut = 0
        for name, t in got.items():
            if ".norm_q." in name or ".norm_k." in name:
                n = t.shape[0]
                want_t = full[name][c["tp"] * n:(c["tp"] + 1) * n]
            else:
                want_t = want[name]
            n_cut += tp_dim(name) is not None
            assert t.shape == want_t.shape, name
            assert torch.equal(t, want_t), name
        # in every block: q, k and v (weight and bias), out's weight and
        # the two gains of both attentions; fc1's weight and bias, fc2's
        # weight
        assert n_cut == cfg.num_layers * (2 * (6 + 1 + 2) + 3)


@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(dp=2, tp=4)],
                         ids=_ids)
def test_cog_shard_state_dict_matches_dit_param_specs(mesh_kw):
    """The CogVideoX DiT (4 heads): each rank's slice of the bridged tree
    == the bridge of the shards JAX's ``shard_pytree`` places on that
    rank's device; the per-head LayerNorm [D], the AdaLN, embeddings and
    head replicated, to_out's and ff.net.2's biases too."""
    kw = dict(num_attention_heads=4)
    jcfg, tcfg = jcdit.tiny_config(**kw), tcdit.tiny_config(**kw)
    params = jcdit.init_cogvideox_dit(jax.random.key(5), jcfg)
    jmesh = _jmesh(mesh_kw)
    placed = jsharding.shard_pytree(params, jmesh)
    full = cogvideox_dit_from_jax(jax.tree.map(np.asarray, params), tcfg)
    mcfg = MeshConfig(**mesh_kw)
    for rank in range(mcfg.size):
        mesh = Mesh(mcfg, rank)
        c = mesh.coords
        dev = jmesh.devices[c["dp"], 0, c["tp"], 0, 0]
        local = jax.tree.map(
            lambda a: next(np.asarray(s.data) for s in a.addressable_shards
                           if s.device == dev), placed)
        want = cogvideox_dit_from_jax(local, tcfg)
        got = cogvideox_dit_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                     mesh)
        assert got.keys() == want.keys() == full.keys()
        n_cut = 0
        for name, t in got.items():
            n_cut += tp_dim(name) is not None
            assert t.shape == want[name].shape, name
            assert torch.equal(t, want[name]), name
        # in every block: q, k and v (weight and bias), out's weight; fc1's
        # weight and bias, fc2's weight
        assert n_cut == jcfg.num_layers * (6 + 1 + 3)
        # the rank's slice loads into a DiT of the rank's width
        tcdit.CogVideoXDiT(tcfg, device="meta", mesh=mesh).load_state_dict(
            got, assign=True, strict=True)


def test_unported_meshes_and_options_raise():
    """pp meshes, int8 under tp or fsdp and training under sp raise
    NotImplementedError naming their ROADMAP items; heads that do not
    divide over tp raise ValueError (sp meshes run:
    tests/test_torch_sp.py; fsdp meshes and training under dp x fsdp x tp:
    tests/test_torch_sharded_training.py)."""
    cfg = tdit.tiny_config(**DIT_KW)
    with pytest.raises(NotImplementedError, match="queue 1, item 12.3"):
        tdit.WanDiT(cfg, device="meta", mesh=Mesh(MeshConfig(pp=2), 0))
    # an fsdp mesh builds, its fsdp-cut weights the rank's slice
    fsdp = tdit.WanDiT(cfg, device="meta", mesh=Mesh(MeshConfig(fsdp=2), 0))
    assert fsdp.blocks[0].attn1.to_q.weight.shape == (
        cfg.inner_dim, cfg.inner_dim // 2)
    with pytest.raises(ValueError):
        tdit.WanDiT(dataclasses.replace(cfg, num_attention_heads=3),
                    device="meta", mesh=Mesh(MeshConfig(tp=2), 0))
    mesh = Mesh(MeshConfig(tp=2), 0)
    gen = torch.Generator().manual_seed(0)
    dit = tdit.init_wan_dit(cfg, gen, mesh=mesh)
    vae = tvae.init_wan_vae(serve.smoke_configs()[1], gen)
    with pytest.raises(NotImplementedError, match="int8"):
        tpipe.WanImageToVideoPipeline(dit, vae, quantize="int8", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        tpipe.WanImageToVideoPipeline(dit, vae)
    with pytest.raises(NotImplementedError, match="int8"):
        tpipe.WanImageToVideoPipeline(fsdp, vae, quantize="int8",
                                      mesh=fsdp.mesh)
    sp = tdit.WanDiT(cfg, device="meta", mesh=Mesh(MeshConfig(sp=2), 0))
    with pytest.raises(NotImplementedError, match="item 12.8"):
        sp(torch.zeros(1, 8, 1, 4, 4), torch.ones(1), torch.zeros(1, 7, 16),
           differentiable=True)
    # the dp-only int8 pipeline is allowed (every rank holds full layers)
    dp_mesh = Mesh(MeshConfig(dp=2), 0)
    tpipe.WanImageToVideoPipeline(
        tdit.init_wan_dit(cfg, gen, mesh=dp_mesh), vae, quantize="int8",
        mesh=dp_mesh)
