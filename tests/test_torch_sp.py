"""The port's sequence parallelism (sp) for both DiTs and its CogVideoX
under dp x tp, on the CPU: the sharded attention functions, the sharded
DiTs and the pipelines in 2 and 4 gloo processes against JAX's sharded
functions on the conftest's 8 virtual devices (interpret-mode Pallas
inside JAX's shard_map) and against the port's unsharded pipelines; the
process layout against JAX's ``make_mesh`` device grid.

The workers (``tests/_torch_parallel_worker.py``) import no jax; inputs
and weights are made here with numpy or by JAX and handed to them. The
module starts 4 gloo processes once (``W.Pool``) and lays each test's mesh
over the first of them (``make_mesh(ranks=)``). All fp32, 4 heads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from frameino_tpu.core.meshes import MeshConfig as JMeshConfig
from frameino_tpu.core.meshes import make_mesh as jmake_mesh
from frameino_tpu.models import cogvideox_dit as jcdit
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.ops import attention as jattn
from frameino_tpu_torch.core.meshes import Mesh, MeshConfig
from frameino_tpu_torch.models import cogvideox_dit as tcdit
from frameino_tpu_torch.models import cogvideox_vae as tcvae
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.ops import attention as tattn
from frameino_tpu_torch.pipelines import cogvideox_i2v as tcpipe
from frameino_tpu_torch.pipelines import wan_i2v as tpipe
from frameino_tpu_torch import serve

# the tiny DiTs with 4 heads
WAN_KW = dict(num_attention_heads=4, attention_head_dim=32, in_channels=8,
              out_channels=4)
COG_KW = dict(num_attention_heads=4)
COG_2B = dict(COG_KW, use_rotary_positional_embeddings=False,
              use_learned_positional_embeddings=False)


@pytest.fixture(scope="module")
def _pool_holder(tmp_path_factory):
    holder = {}
    yield holder, tmp_path_factory
    if holder:
        holder["pool"].close()


@pytest.fixture
def pool(_pool_holder):
    """The module's 4 worker processes (started again after a failed job
    left them out of step)."""
    holder, factory = _pool_holder
    if not holder or holder["pool"].broken:
        if holder:
            holder["pool"].close()
        holder["pool"] = W.Pool(4, factory.mktemp("pool"))
    return holder["pool"]


def _ids(kw):
    return "x".join(f"{k}{v}" for k, v in kw.items())


def _jmesh(mesh_kw):
    cfg = JMeshConfig(**mesh_kw)
    return jmake_mesh(cfg, devices=jax.devices()[:cfg.size])


def _load(tmp_path, name, world):
    return [np.load(tmp_path / f"{name}_{r}.npy") for r in range(world)]


def _rope(S, D, seed):
    """Real RoPE tables (rotations) of S positions."""
    ang = np.random.RandomState(seed).uniform(0, 2 * np.pi, (S, D // 2))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _shard(ref, mesh_kw, rank, seq=True):
    """Rank ``rank``'s [batch, head, sequence] shard of a global [B, H, S,
    D] array (the sequence whole without ``seq``)."""
    cfg = MeshConfig(**mesh_kw)
    c = Mesh(cfg, rank).coords
    B, H, S = ref.shape[:3]
    bl, hl, sl = B // cfg.dp, H // cfg.tp, (S // cfg.sp if seq else S)
    s0 = c["sp"] * sl if seq else 0
    return ref[c["dp"] * bl:(c["dp"] + 1) * bl,
               c["tp"] * hl:(c["tp"] + 1) * hl, s0:s0 + sl]


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_kw", [dict(tp=2), dict(tp=4),
                                     dict(dp=2, tp=2)], ids=_ids)
def test_fused_ln_sharded_attention_matches_jax(pool, tmp_path, mesh_kw):
    """K4's plain version on the rank's heads -> per-rank bound -> K1's
    plain version == JAX's shard_map of ``_qk_producer_ln`` and
    ``_flash_fwd_static`` (interpret): joint attention over 9 text rows
    (identity RoPE rows) and 291 video rows, fp32."""
    B, H, L, S, D, eps = 2, 4, 9, 300, 64, 1e-6
    rs = np.random.RandomState(21)
    q_raw, k_raw = (rs.randn(B, S, H * D).astype(np.float32)
                    for _ in range(2))
    v = rs.randn(B, H, S, D).astype(np.float32)
    w_q, w_k = ((1 + 0.1 * rs.randn(D)).astype(np.float32) for _ in range(2))
    b_q, b_k = ((0.1 * rs.randn(D)).astype(np.float32) for _ in range(2))
    cos, sin = _rope(S, D, 22)
    cos[:L], sin[:L] = 1.0, 0.0
    mesh = _jmesh(mesh_kw)
    with mesh:
        ref = jax.jit(lambda *a: jattn.fused_ln_qk_flash_attention_sharded(
            *a, mesh, num_heads=H, head_dim=D, eps=eps, interpret=True))(
            q_raw, k_raw, v, w_q, b_q, w_k, b_k, cos, sin)
    ref = np.asarray(ref)
    world = MeshConfig(**mesh_kw).size
    pool.run(W.ln_attention, tmp_path, mesh_kw, q_raw, k_raw, v, w_q,
            b_q, w_k, b_k, cos, sin, H, eps)
    for r, out in enumerate(_load(tmp_path, "attn", world)):
        # fp32 on both sides; sums in another order (2e-5, as JAX holds
        # its sharded path to its unsharded one)
        np.testing.assert_allclose(out, _shard(ref, mesh_kw, r, seq=False),
                                   atol=2e-5, rtol=2e-5)


def _qkv(S, Skv, seed, B=2, H=4, D=32):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, S, D).astype(np.float32),
            rs.randn(B, H, Skv, D).astype(np.float32),
            rs.randn(B, H, Skv, D).astype(np.float32))


@pytest.mark.parametrize("gather_kv", [True, False], ids=["gather", "text"])
@pytest.mark.parametrize("mesh_kw", [dict(sp=2), dict(tp=2, sp=2)],
                         ids=_ids)
def test_sp_attention_matches_jax(pool, tmp_path, mesh_kw, gather_kv):
    """The rank's query shard against the keys gathered over sp (K3's
    plain version over the whole sequence), or against 37 replicated text
    keys, == JAX's ``sp_attention`` (Pallas K3 in interpret mode inside
    the shard_map), fp32."""
    q, k, v = _qkv(258, 258 if gather_kv else 37, 31)
    mesh = _jmesh(mesh_kw)
    jattn.FORCE_INTERPRET = True
    try:
        with mesh:
            ref = jax.jit(lambda q, k, v: jattn.sp_attention(
                q, k, v, mesh, gather_kv=gather_kv, impl="pallas"))(q, k, v)
    finally:
        jattn.FORCE_INTERPRET = False
    ref = np.asarray(ref)
    world = MeshConfig(**mesh_kw).size
    pool.run(W.sp_attention, tmp_path, mesh_kw, q, k, v, gather_kv,
            "allgather")
    for r, out in enumerate(_load(tmp_path, "attn", world)):
        np.testing.assert_allclose(out, _shard(ref, mesh_kw, r), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("mesh_kw", [dict(sp=2), dict(sp=4)], ids=_ids)
def test_ring_attention_matches_jax(pool, tmp_path, mesh_kw):
    """The fp32 online-softmax ring (the k/v shards passed i -> i + 1 by
    batched isend/irecv) == JAX's ``ring_attention`` (ppermute inside the
    shard_map), fp32; and taking the heads one at a time changes no bit."""
    q, k, v = _qkv(260, 260, 41)
    mesh = _jmesh(mesh_kw)
    with mesh:
        ref = jax.jit(lambda q, k, v: jattn.ring_attention(q, k, v, mesh))(
            q, k, v)
    ref = np.asarray(ref)
    world = MeshConfig(**mesh_kw).size
    pool.run(W.sp_attention, tmp_path, mesh_kw, q, k, v, True, "ring")
    chunked = _load(tmp_path, "ring_chunk1", world)
    for r, out in enumerate(_load(tmp_path, "attn", world)):
        np.testing.assert_allclose(out, _shard(ref, mesh_kw, r), atol=2e-5,
                                   rtol=2e-5)
        # heads are independent: the head-chunked ring is the same ring
        np.testing.assert_array_equal(chunked[r], out)


def test_ring_head_chunk_sizes_the_scores():
    """The default chunk keeps a hop's fp32 scores near RING_SCORE_BYTES:
    all 24 heads at Wan's sp = 2 shard (1.43 GB), 2 of CogVideoX's 48
    (35.1 GB whole), never fewer than one."""
    assert tattn.ring_head_chunk(2, 24, 2730, 2730) == 24
    n = tattn.ring_head_chunk(2, 48, 9563, 9563)
    assert n == tattn.RING_SCORE_BYTES // (2 * 9563 * 9563 * 4) == 2
    assert 2 * n * 9563 * 9563 * 4 <= tattn.RING_SCORE_BYTES
    assert tattn.ring_head_chunk(8, 48, 60000, 60000) == 1


# ---------------------------------------------------------------------------
# the DiTs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cog_params():
    """JAX trees of the tiny CogVideoX DiT (4 heads) in the 5B layout and
    the 2B's, their position tables random (text slots included)."""
    out = {}
    for name, kw in (("5b", COG_KW), ("2b", COG_2B)):
        cfg = jcdit.tiny_config(**kw)
        params = jcdit.init_cogvideox_dit(jax.random.key(7), cfg)
        pos = params["patch_embed"]["pos_embedding"]
        params["patch_embed"]["pos_embedding"] = jnp.asarray(
            np.random.RandomState(8).randn(*pos.shape).astype(np.float32))
        out[name] = (cfg, params)
    return out


def _cog_args(cfg, seed=9):
    """3 frames at 8x8 after 8 text tokens: S = 8 + 3 * 4 * 4 = 56, which
    sp = 2 and 4 divide (the text length of JAX's own sp test)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 3, cfg.in_channels, 8, 8).astype(np.float32)
    text = rs.randn(2, 8, cfg.text_embed_dim).astype(np.float32)
    t = np.array([999.0, 400.0], np.float32)
    rope = (tuple(np.asarray(a) for a in jcdit.cogvideox_rope(cfg, 3, 8, 8))
            if cfg.use_rotary_positional_embeddings else None)
    return x, text, t, rope


@pytest.mark.parametrize("layout,mesh_kw", [
    ("5b", dict(tp=2)), ("5b", dict(dp=2, tp=2)), ("5b", dict(sp=2)),
    ("2b", dict(tp=2))], ids=lambda a: a if isinstance(a, str) else _ids(a))
def test_cog_dit_matches_jax(pool, tmp_path, cog_params, layout, mesh_kw):
    """The tiny CogVideoX DiT, sharded over the mesh from the bridged JAX
    tree, on every rank == JAX's ``cogvideox_forward(attn_impl="pallas",
    mesh=)``: on tp meshes the fused sharded K4 -> K1 (the 2B: K3 on the
    rank's heads), at sp = 2 the plain LayerNorm and RoPE, then K3 over
    the keys gathered over sp (interpret-mode Pallas), fp32."""
    cfg, params = cog_params[layout]
    x, text, t, rope = _cog_args(cfg)
    mesh = _jmesh(mesh_kw)
    jattn.FORCE_INTERPRET = True
    try:
        with mesh:
            ref = jax.jit(lambda p, x, c, t: jcdit.cogvideox_forward(
                cfg, p, x, c, t, image_rotary_emb=rope, attn_impl="pallas",
                mesh=mesh))(params, x, text, t)
    finally:
        jattn.FORCE_INTERPRET = False
    ref = np.asarray(ref)
    world = MeshConfig(**mesh_kw).size
    pool.run(W.cog_dit, tmp_path, mesh_kw,
            COG_KW if layout == "5b" else COG_2B,
            jax.tree.map(np.asarray, params), x, text, t, rope)
    for out in _load(tmp_path, "dit", world):
        # fp32 through 2 blocks; reordered sums (1e-4, as the unsharded
        # DiT is held to JAX's)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def wan_params():
    cfg = jdit.tiny_config(**WAN_KW)
    params = jdit.init_wan_dit(jax.random.key(13), cfg)
    rs = np.random.RandomState(14)
    B, F, Hh, Ww = 2, 3, 4, 6
    x = rs.randn(B, 8, F, Hh, Ww).astype(np.float32)
    t = np.array([999.0, 357.5], np.float32)
    ctx = rs.randn(B, 7, 16).astype(np.float32)
    S = F * (Hh // 2) * (Ww // 2)                 # 18: sp = 2 divides
    mask = np.ones((B, S), np.float32)
    mask[:, :S // F] = 0.0
    return cfg, params, (x, t, ctx, mask)


@pytest.mark.parametrize("mesh_kw,method", [
    (dict(sp=2), "allgather"), (dict(tp=2, sp=2), "allgather"),
    (dict(dp=2, sp=2), "allgather"), (dict(sp=2), "ring")],
    ids=lambda a: a if isinstance(a, str) else _ids(a))
def test_wan_dit_sp_matches_jax(pool, tmp_path, wan_params, mesh_kw, method):
    """The tiny Wan DiT over an sp mesh, with the text K/V projected in
    the forward and hoisted, on every rank == JAX's
    ``wan_dit_forward(attn_impl="pallas", mesh=)`` under the same
    ``DEFAULT_SP_METHOD``: the per-token timestep rows and the RoPE rows
    cut with the tokens, the RMS statistic all-reduced over tp, K3 over
    the gathered keys or the fp32 ring (interpret-mode Pallas), fp32."""
    cfg, params, args = wan_params
    mesh = _jmesh(mesh_kw)
    jattn.FORCE_INTERPRET = True
    jattn.DEFAULT_SP_METHOD = method
    try:
        with mesh:
            ref = jax.jit(lambda p, x, t, c, m: jdit.wan_dit_forward(
                cfg, p, x, t, c, timestep_mask=m, attn_impl="pallas",
                mesh=mesh))(params, *args)
    finally:
        jattn.FORCE_INTERPRET = False
        jattn.DEFAULT_SP_METHOD = "allgather"
    ref = np.asarray(ref)
    world = MeshConfig(**mesh_kw).size
    pool.run(W.dit, tmp_path, mesh_kw, WAN_KW,
            jax.tree.map(np.asarray, params), *args, method)
    for name in ("dit", "dit_kv"):
        for out in _load(tmp_path, name, world):
            np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_wan_dit_indivisible_sequence_equals_unsharded(pool, tmp_path,
                                                       wan_params):
    """A sequence sp does not divide (3 frames of 2x6 latents: 9 tokens)
    runs whole on every sp rank, no sp collective: == JAX's unsharded
    forward (JAX's own fallback, test_sp_integration)."""
    cfg, params, (_, t, ctx, _) = wan_params
    x = np.random.RandomState(15).randn(2, 8, 3, 2, 6).astype(np.float32)
    ref = np.asarray(jdit.wan_dit_forward(cfg, params, x, t, ctx))
    mesh_kw = dict(tp=2, sp=2)
    pool.run(W.dit, tmp_path, mesh_kw, WAN_KW,
            jax.tree.map(np.asarray, params), x, t, ctx, None)
    for out in _load(tmp_path, "dit", 4):
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def _cog_pipeline_inputs():
    rs = np.random.RandomState(19)
    P, F = 16, 9
    image = np.tanh(rs.randn(1, 3, P, P)).astype(np.float32)
    traj = np.tanh(rs.randn(1, 3, F, P, P)).astype(np.float32)
    idf = np.tanh(rs.randn(1, 3, P, P)).astype(np.float32)
    text = rs.randn(1, 8, 16).astype(np.float32)
    latents = rs.randn(1, 3, 4, P // 4, P // 4).astype(np.float32)
    kw = dict(height=P, width=P, num_frames=F, num_inference_steps=2,
              guidance_scale=6.0)
    return (image, traj, idf, text, latents), kw


COG_PIPE_KW = dict(COG_KW, use_frame_in=True)


def test_cog_pipeline_tp2_matches_unsharded(pool, tmp_path):
    """The tiny CogVideoX FrameINO pipeline at tp = 2 (the DiT sliced from
    the same seeded init, the VAE on rank 0 only, 2 CFG steps with the
    dynamic schedule) == the port's unsharded pipeline, fp32; only rank 0
    returns the video."""
    gen = torch.Generator().manual_seed(11)
    vae_cfg = tcvae.tiny_vae_config()
    dit = tcdit.init_cogvideox_dit(tcdit.tiny_config(**COG_PIPE_KW), gen)
    vae = tcvae.init_cogvideox_vae(vae_cfg, gen)
    inputs, kw = _cog_pipeline_inputs()
    image, traj, idf, text, latents = (torch.from_numpy(a) for a in inputs)
    want = tcpipe.CogVideoXImageToVideoPipeline(dit, vae)(
        image, prompt_embeds=text, traj_tensor=traj, id_tensor=idf,
        latents=latents, **kw)
    pool.run(W.cog_pipeline, tmp_path, dict(tp=2), COG_PIPE_KW, vae_cfg,
            inputs, kw)
    got = np.load(tmp_path / "video_0.npy")
    assert not (tmp_path / "video_1.npy").exists()
    assert got.shape == (1, 3, 9, 16, 16)
    # fp32; the sharded sums and K1's static softmax reorder (1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_wan_pipeline_sp2_matches_unsharded(pool, tmp_path):
    """The tiny Wan pipeline at sp = 2 (6 latent frames of 8x8 with the ID
    frame: 96 tokens, 48 a rank) == the port's unsharded pipeline, fp32;
    only rank 0 returns the video."""
    _, vae_cfg = serve.smoke_configs()
    gen = torch.Generator().manual_seed(0)
    dit = tdit.init_wan_dit(tdit.tiny_config(**WAN_KW), gen)
    vae = tvae.init_wan_vae(vae_cfg, gen)
    rs = np.random.RandomState(7)
    H = W_ = 16
    inputs = (np.tanh(rs.randn(1, 3, H, W_)).astype(np.float32),
              rs.randn(1, 7, 16).astype(np.float32),
              np.tanh(rs.randn(1, 3, 9, H, W_)).astype(np.float32),
              np.tanh(rs.randn(1, 3, 1, H, W_)).astype(np.float32),
              rs.randn(1, 4, 5, H // 2, W_ // 2).astype(np.float32))
    kw = dict(height=H, width=W_, num_frames=9, num_inference_steps=2,
              guidance_scale=5.0)
    image, text, traj, ids, latents = (torch.from_numpy(a) for a in inputs)
    want = tpipe.WanImageToVideoPipeline(dit, vae)(
        image, prompt_embeds=text, traj_tensor=traj, id_tensor=ids,
        latents=latents, **kw)
    pool.run(W.pipeline, tmp_path, dict(sp=2), WAN_KW, vae_cfg, inputs,
            kw)
    got = np.load(tmp_path / "video_0.npy")
    assert not (tmp_path / "video_1.npy").exists()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_matches_jax_device_grid(pool, tmp_path):
    """make_mesh over 4 gloo processes: at tp = 2 x sp = 2 each process's
    coordinates are those of its device in JAX's ``make_mesh`` grid, its
    tp group the devices that differ from it in tp alone, its sp group in
    sp alone; ``ranks=[0, 1]`` lays an sp = 2 mesh over the first two
    (the others get None) as JAX's ``devices=`` does."""
    pool.run(W.mesh_layout, tmp_path)
    rows = _load(tmp_path, "layout", 4)
    for kw, devs in ((dict(tp=2, sp=2), 4), (dict(sp=2), 2)):
        jm = jmake_mesh(JMeshConfig(**kw), devices=jax.devices()[:devs])
        # axes (dp, fsdp, tp, sp, pp) -> the device id at each coordinate
        grid = np.vectorize(lambda d: d.id)(jm.devices)
        for proc in range(4):
            row = rows[proc][0 if "tp" in kw else 1]
            if proc >= devs:
                assert (row == -1).all()
                continue
            rank, dp, tp, sp = row[:4]
            assert rank == proc and grid[dp, 0, tp, sp, 0] == proc
            tp_line = grid[dp, 0, :, sp, 0]
            sp_line = grid[dp, 0, tp, :, 0]
            dp_line = grid[:, 0, tp, sp, 0]
            for i, line in enumerate((tp_line, dp_line, sp_line)):
                assert (row[4 + i], row[7 + i]) == (line.min(), line.max())
    with pytest.raises(NotImplementedError, match="queue 1, item 12.3"):
        tdit.WanDiT(tdit.tiny_config(**WAN_KW), device="meta",
                    mesh=Mesh(MeshConfig(pp=2), 0))


def test_cog_unported_options_raise():
    """The CogVideoX DiT under a mesh: pp, training under sp, the plain
    "xla" path and heads that do not divide over tp raise; the pipeline
    refuses int8 under tp or fsdp and a DiT built on another mesh, allows
    int8 on dp alone."""
    cfg = tcdit.tiny_config(**COG_KW)
    with pytest.raises(NotImplementedError, match="queue 1, item 12.3"):
        tcdit.CogVideoXDiT(cfg, device="meta",
                           mesh=Mesh(MeshConfig(pp=2), 0))
    with pytest.raises(ValueError, match="divide"):
        tcdit.CogVideoXDiT(dataclasses.replace(cfg, num_attention_heads=3),
                           device="meta", mesh=Mesh(MeshConfig(tp=2), 0))
    mesh = Mesh(MeshConfig(tp=2), 0)
    gen = torch.Generator().manual_seed(0)
    dit = tcdit.init_cogvideox_dit(cfg, gen, mesh=mesh)
    x, text, t = (torch.zeros(1, 3, 12, 8, 8), torch.zeros(1, 8, 16),
                  torch.ones(1))
    rope = tcdit.cogvideox_rope(cfg, 3, 8, 8)
    sp_dit = tcdit.CogVideoXDiT(cfg, device="meta",
                                mesh=Mesh(MeshConfig(sp=2), 0))
    with pytest.raises(NotImplementedError, match="item 12.8"):
        sp_dit(x, text, t, rope, differentiable=True)
    with pytest.raises(ValueError, match="xla"):
        dit(x, text, t, rope, attn_impl="xla")
    vae = tcvae.init_cogvideox_vae(tcvae.tiny_vae_config(), gen)
    with pytest.raises(NotImplementedError, match="int8"):
        tcpipe.CogVideoXImageToVideoPipeline(dit, vae, quantize="int8",
                                             mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        tcpipe.CogVideoXImageToVideoPipeline(dit, vae)
    with pytest.raises(ValueError, match="rank 0"):
        tcpipe.CogVideoXImageToVideoPipeline(dit, None, mesh=mesh)
    fsdp_mesh = Mesh(MeshConfig(fsdp=2), 0)
    with pytest.raises(NotImplementedError, match="int8"):
        tcpipe.CogVideoXImageToVideoPipeline(
            tcdit.init_cogvideox_dit(cfg, gen, mesh=fsdp_mesh), vae,
            quantize="int8", mesh=fsdp_mesh)
    dp_mesh = Mesh(MeshConfig(dp=2), 0)
    tcpipe.CogVideoXImageToVideoPipeline(
        tcdit.init_cogvideox_dit(cfg, gen, mesh=dp_mesh), vae,
        quantize="int8", mesh=dp_mesh)
