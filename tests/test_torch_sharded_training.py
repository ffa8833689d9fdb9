"""The port's sharded training (dp x fsdp x tp) on the CPU: the process
mesh with fsdp against JAX's device grid, the fsdp layout against JAX's
``dit_param_specs``, the sharded Wan and CogVideoX train steps in 4 gloo
processes against JAX's sharded steps on the conftest's virtual devices
and against the port's one process, the optimizer rules on shards
against optax, a batch that dp x fsdp does not divide, the planted
faults of ``chip_smoke.py``'s train meshes, a sharded checkpoint restored
on one process and on another mesh, and the Wan pipeline at fsdp 2.

The workers (``tests/_torch_parallel_worker.py``) import no jax. The
module starts 4 gloo processes once (``W.Pool``), lays each job's mesh
over them and hands them whole weights, batches (latents: no VAE encode)
and JAX's draws. Tiny configs, fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_parallel_worker as W
from frameino_tpu.core.meshes import MeshConfig as JMeshConfig
from frameino_tpu.core.meshes import make_mesh as jmake_mesh
from frameino_tpu.models import cogvideox_dit as jcdit
from frameino_tpu.models import wan_dit as jdit
from frameino_tpu.models import wan_vae as jvae
from frameino_tpu.parallel import sharding as jsharding
from frameino_tpu.training import cog_trainer as jcog
from frameino_tpu.training import optim as joptim
from frameino_tpu.training import trainer as jtrainer
from frameino_tpu.training.noise_sampler import \
    stratified_timestep_indices as jstratified
from frameino_tpu_torch import serve
from frameino_tpu_torch.core.checkpoint import restore_checkpoint
from frameino_tpu_torch.core.meshes import Mesh, MeshConfig
from frameino_tpu_torch.models import cogvideox_dit as tcdit
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import (cogvideox_dit_from_jax,
                                               wan_dit_from_jax)
from frameino_tpu_torch.parallel.sharding import shard_state_dict, tp_dim
from frameino_tpu_torch.pipelines import wan_i2v as tpipe
from frameino_tpu_torch.training import cog_trainer as tcog
from frameino_tpu_torch.training import optim as toptim
from frameino_tpu_torch.training import trainer as ttrainer

WAN_KW = dict(num_attention_heads=4, attention_head_dim=32, in_channels=8,
              out_channels=4)
COG_KW = dict(num_attention_heads=4, use_frame_in=True)
# the tiny VAE config of tests/test_training.py (the JAX step's signature
# takes one; the batches carry latents, so it never runs, and its
# parameters are None: JAX's eager init of them takes ~50 s here)
VAE_KW = dict(base_dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
              temperal_downsample=(True,), is_residual=False, patch_size=None,
              scale_factor_temporal=2, scale_factor_spatial=2,
              latents_mean=(0.0,) * 4, latents_std=(1.0,) * 4)
OCFG = dict(learning_rate=1e-3, lr_warmup_steps=1)
MESHES = [dict(dp=2, fsdp=2), dict(fsdp=2, tp=2), dict(dp=2, tp=2),
          dict(fsdp=4)]
B = 4
# fp32 limits. The sharded step differs from one process only in the
# order of its sums (the row-parallel and reduce-scattered partial sums,
# the batch mean over ranks): loss and grad_norm to 1e-5 relative, the
# AdamW moments to 1e-4 relative L2. Against JAX (XLA's attention and
# its own sums) the parameters' movement is held to 1e-3 relative L2 as
# tests/test_torch_training.py holds one process, the moments to 1e-3.
STEP_RTOL, MOMENT_REL, JAX_REL = 1e-5, 1e-4, 1e-3


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


def _replicated_leaves(state, jmesh):
    """JAX's sharded train state with its single-device leaves (the
    optimizer's counters) replicated over the mesh, as the step returns
    them: the step's second call then reuses the first's compile."""
    rep = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec())
    return jax.tree.map(lambda a: a if len(a.sharding.device_set) > 1
                        else jax.device_put(a, rep), state)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _slot(opt_state, field):
    """The params-shaped ``field`` ("mu", "nu") of an optax state."""
    if hasattr(opt_state, "_fields") and field in opt_state._fields:
        return getattr(opt_state, field)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            got = _slot(s, field)
            if got is not None:
                return got
    return None


# ---------------------------------------------------------------------------
# the mesh and the layout
# ---------------------------------------------------------------------------

def test_make_mesh_fsdp_matches_jax_device_grid(pool, tmp_path):
    """make_mesh at dp 2 x fsdp 2 and fsdp 2 x tp 2 over 4 gloo
    processes: each process's coordinates are its device's in JAX's
    ``make_mesh`` grid, its fsdp group the devices that differ from it in
    fsdp alone, its batch group those that differ in dp or fsdp (in
    (dp, fsdp) order, which is its batch rank's)."""
    pool.run(W.mesh_layout_fsdp, tmp_path)
    rows = [np.load(tmp_path / f"layout_{r}.npy") for r in range(4)]
    for i, kw in enumerate((dict(dp=2, fsdp=2), dict(fsdp=2, tp=2))):
        grid = np.vectorize(lambda d: d.id)(_jmesh(kw).devices)
        for proc in range(4):
            rank, dp, fs, tp, sp, brank = rows[proc][i][:6]
            assert rank == proc and grid[dp, fs, tp, sp, 0] == proc
            assert list(rows[proc][i][6:8]) == list(grid[dp, :, tp, sp, 0])
            batch = grid[:, :, tp, sp, 0].reshape(-1)
            assert list(rows[proc][i][8:8 + batch.size]) == list(batch)
            assert batch[brank] == proc


@pytest.mark.parametrize("mesh_kw", [dict(fsdp=2), dict(dp=2, fsdp=2),
                                     dict(fsdp=2, tp=2)], ids=_ids)
def test_shard_state_dict_fsdp_matches_dit_param_specs(mesh_kw):
    """Each rank's slice of the bridged tiny Wan tree is the part of it
    that JAX's ``shard_pytree`` places on that rank's device: the bridge
    of the whole tree zeroed outside the device's shards holds the rank's
    slice unchanged, and the device's shard of each tensor has as many
    elements as the rank's slice (the qk-norm gains aside under tp: the
    port cuts them to the rank's heads, JAX replicates them); fsdp cuts
    the column-parallel weights' input dim and the row-parallel ones'
    output dim."""
    tcfg, jcfg = tdit.tiny_config(**WAN_KW), jdit.tiny_config(**WAN_KW)
    params = jdit.init_wan_dit(jax.random.key(3), jcfg)
    jmesh = _jmesh(mesh_kw)
    placed = jsharding.shard_pytree(params, jmesh)
    full = wan_dit_from_jax(jax.tree.map(np.asarray, params), tcfg)
    mcfg = MeshConfig(**mesh_kw)
    for rank in range(mcfg.size):
        mesh = Mesh(mcfg, rank)
        c = mesh.coords
        dev = jmesh.devices[c["dp"], c["fsdp"], c["tp"], 0, 0]

        def on_device(a):
            shard = next(s for s in a.addressable_shards if s.device == dev)
            out = np.zeros(a.shape, np.float32)
            out[shard.index] = np.asarray(shard.data)
            return out
        masked = wan_dit_from_jax(jax.tree.map(on_device, placed), tcfg)
        counts = wan_dit_from_jax(jax.tree.map(
            lambda a: on_device(jax.device_put(jnp.ones(a.shape, a.dtype),
                                               a.sharding)), placed), tcfg)
        got = shard_state_dict(full, mesh)
        assert got.keys() == full.keys()
        for name, t in got.items():
            assert torch.equal(shard_state_dict(masked, mesh)[name], t), name
            if not ((".norm_q." in name or ".norm_k." in name)
                    and mesh.tp > 1):
                assert int(counts[name].sum()) == t.numel(), name
        q = got["blocks.0.attn1.to_q.weight"]
        assert q.shape == (tcfg.inner_dim // mesh.tp,
                           tcfg.inner_dim // mesh.fsdp)
        assert got["blocks.0.ffn.net.2.weight"].shape == (
            tcfg.inner_dim // mesh.fsdp, tcfg.ffn_dim // mesh.tp)
        # the port's model of the rank's slice takes it
        tdit.WanDiT(tcfg, device="meta", mesh=mesh).load_state_dict(
            got, assign=True, strict=True)


@pytest.mark.parametrize("family", ["wan", "cog"])
def test_fsdp_rank_memory_matches_jax_at_full_width(family):
    """At full width (Wan2.2-TI2V-5B-motion, CogVideoX-5B-I2V-FrameINO;
    meta tensors and ``jax.eval_shape``, nothing allocated) each rank of
    fsdp 4, dp 2 x fsdp 2 and dp 2 x fsdp 4 holds tensors of the same
    sizes as JAX's ``dit_param_specs`` put on a device, block by block
    (JAX's default rule counts a block's tensor over every block), and
    under 1.05 times the whole model's fsdp-th part."""
    if family == "wan":
        init, jcfg = jdit.init_wan_dit, jdit.WAN22_TI2V_5B_MOTION
        cls, tcfg = tdit.WanDiT, tdit.WAN22_TI2V_5B_MOTION
    else:
        init, jcfg = jcdit.init_cogvideox_dit, jcdit.COGVIDEOX_5B_I2V_FRAMEINO
        cls, tcfg = tcdit.CogVideoXDiT, tcdit.COGVIDEOX_5B_I2V_FRAMEINO
    params = jax.eval_shape(lambda: init(jax.random.key(0), jcfg))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for mesh_kw in (dict(fsdp=4), dict(dp=2, fsdp=2), dict(dp=2, fsdp=4)):
        jmesh = _jmesh(mesh_kw)
        specs = jax.tree.leaves(
            jsharding.dit_param_specs(params, jmesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = []
        for (path, leaf), spec in zip(flat, specs):
            div = int(np.prod([jmesh.shape[a] for ax in spec if ax
                               for a in (ax if isinstance(ax, tuple)
                                         else (ax,))]))
            layers = leaf.shape[0] if "'blocks'" in jax.tree_util.keystr(
                path) else 1
            want += [int(np.prod(leaf.shape)) // div // layers] * layers
        model = cls(tcfg, device="meta", mesh=Mesh(MeshConfig(**mesh_kw),
                                                   0))
        got = [t.numel() for t in list(model.parameters())
               + list(model.buffers())]
        assert sorted(got) == sorted(want), mesh_kw
        # the replicated tensors (time embedding, norms, biases) add
        # under 5% to the whole model's fsdp-th part
        assert sum(got) <= sum(t.numel() for t in cls(
            tcfg, device="meta").parameters()) / mesh_kw["fsdp"] * 1.05


# ---------------------------------------------------------------------------
# the sharded train steps
# ---------------------------------------------------------------------------

def _wan_batches(seed=0, n=2, batch=B):
    rs = np.random.RandomState(seed)

    def a(*shape):
        return rs.randn(*shape).astype(np.float32)
    return [{"video_latents": a(batch, 4, 3, 8, 8),
             "first_frame_latent": a(batch, 4, 1, 8, 8),
             "traj_latents": a(batch, 4, 3, 8, 8),
             "id_latents": a(batch, 4, 1, 8, 8),
             "prompt_embeds": a(batch, 7, 16)} for _ in range(n)]


def _wan_draws(key, step, dp, batch=B):
    """The JAX step's draws: fold_in(key, step), split, the stratified
    indices over dp ranks, the normal noise of x0's shape."""
    k_idx, k_noise = jax.random.split(jax.random.fold_in(key, step))
    idx = jstratified(k_idx, batch, 1000, world_size=dp)
    noise = jax.random.normal(k_noise, (batch, 4, 3, 8, 8), jnp.float32)
    return np.array(idx).astype(np.int64), np.array(noise)


@pytest.fixture(scope="module")
def wan_setup():
    """The tiny Wan DiT's JAX weights and their bridge, the batches, and
    JAX's sharded step (``make_sharded_train_state`` +
    ``make_train_step(mesh=, dp_size=dp)``, as JAX's entry builds them)
    over 2 steps on a mesh: the draws (stratified over the mesh's dp),
    the metrics and the state after, computed once a mesh (~10 s of
    compile on this host; ``_replicated_leaves`` spares a second)."""
    jcfg, tcfg = jdit.tiny_config(**WAN_KW), tdit.tiny_config(**WAN_KW)
    params = jdit.init_wan_dit(jax.random.key(1), jcfg)
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**OCFG))
    tc = jtrainer.TrainerConfig(compute_dtype=jnp.float32, remat=False,
                                attn_impl="xla")
    batches = _wan_batches()
    key = jax.random.key(42)
    refs = {}

    def jax_step(mesh_kw):
        tag = _ids(mesh_kw)
        if tag in refs:
            return refs[tag]
        jmesh = _jmesh(mesh_kw)
        dp = mesh_kw.get("dp", 1)
        with jmesh:
            state = _replicated_leaves(jtrainer.make_sharded_train_state(
                jax.tree.map(jnp.array, params), opt, jmesh), jmesh)
            step = jtrainer.make_train_step(
                jcfg, jvae.WanVAEConfig(**VAE_KW), tc, opt, mesh=jmesh,
                dp_size=dp)
            metrics = []
            for b in batches:
                state, m = step(state, None,
                                {k: jnp.asarray(v) for k, v in b.items()},
                                key)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
        assert not state.params["blocks"]["attn1"]["to_q"][
            "kernel"].sharding.is_fully_replicated
        refs[tag] = dict(
            draws=[_wan_draws(key, i, dp) for i in range(2)],
            metrics=np.array(metrics),
            params=wan_dit_from_jax(jax.tree.map(np.asarray, state.params),
                                    tcfg),
            **{s: wan_dit_from_jax(jax.tree.map(
                np.asarray, _slot(state.opt_state, s)), tcfg)
               for s in ("mu", "nu")})
        return refs[tag]

    sd = {k: v.numpy() for k, v in wan_dit_from_jax(
        jax.tree.map(np.asarray, params), tcfg).items()}
    return sd, batches, jax_step


def _one_process(sd, batches, draws, cfg_kw=WAN_KW, ocfg=OCFG):
    """The port's unsharded steps on the same weights and draws."""
    model = tdit.WanDiT(tdit.tiny_config(**cfg_kw), device="meta")
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in sd.items()}, assign=True)
    state = ttrainer.init_train_state(model, toptim.OptimizerConfig(**ocfg))
    metrics = []
    for b, d in zip(batches, draws):
        m = ttrainer.train_step(
            state, None, ttrainer.TrainerConfig(compute_dtype=torch.float32,
                                                remat=False),
            {k: torch.from_numpy(v.copy()) for k, v in b.items()}, seed=0,
            draws=tuple(torch.from_numpy(np.array(a)) for a in d))
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    return state, np.array(metrics)


def _check_against_one_process(got, state, metrics, rtol=STEP_RTOL,
                               moment_rel=MOMENT_REL):
    np.testing.assert_allclose(got["metrics"], metrics, rtol=rtol)
    start = None
    for name, p in state.params().items():
        for slot in ("mu", "nu"):
            want = getattr(state.optimizer, slot)[name].numpy()
            assert _rel(got[f"{slot}/{name}"], want) <= moment_rel, (
                slot, name)
        np.testing.assert_allclose(got[f"param/{name}"],
                                   p.detach().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    return start


@pytest.mark.parametrize("mesh_kw", MESHES, ids=_ids)
def test_wan_train_step_matches_jax(pool, tmp_path, wan_setup, mesh_kw):
    """Two AdamW steps (lr 1e-3 after a warmup of 1, clip 1.0; the
    second with remat) of the port's sharded step, each rank handed only
    its examples: loss and grad_norm at each step, the gathered
    parameters and AdamW moments after, against JAX's sharded step on the
    same mesh and the port's one process on the same draws (limits:
    STEP_RTOL, MOMENT_REL, JAX_REL)."""
    sd, batches, jax_step = wan_setup
    want = jax_step(mesh_kw)
    pool.run(W.train_steps, tmp_path, mesh_kw, "wan", WAN_KW, sd, batches,
             want["draws"], OCFG, True)
    got = dict(np.load(tmp_path / "train.npz"))
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-4)
    for name, start in sd.items():
        moved = got[f"param/{name}"] - start
        assert _rel(moved, want["params"][name].numpy() - start) <= \
            JAX_REL, name
        for slot in ("mu", "nu"):
            assert _rel(got[f"{slot}/{name}"], want[slot][name].numpy()) \
                <= JAX_REL, (slot, name)
    state, metrics = _one_process(sd, batches, want["draws"])
    _check_against_one_process(got, state, metrics)


def _cog_batches(seed=5, n=2):
    rs = np.random.RandomState(seed)

    def a(*shape):
        return rs.randn(*shape).astype(np.float32)
    return [{"video_latents": a(B, 3, 4, 8, 8),
             "first_frame_latent": a(B, 3, 4, 8, 8),
             "traj_latents": a(B, 3, 4, 8, 8),
             "id_latent": a(B, 1, 4, 8, 8),
             "prompt_embeds": a(B, 8, 16)} for _ in range(n)]


def test_cog_train_step_matches_jax(pool, tmp_path):
    """Two AdamW steps of the port's sharded CogVideoX step at dp 2 x
    fsdp 2 (the tiny FrameINO DiT with the ID frame; latents in the
    batch) against JAX's sharded step on the virtual mesh (its
    ``cog_vpred_loss`` under ``value_and_grad``, ``constrain_like_params``
    and the optax update from ``make_sharded_train_state``, as
    ``make_cog_train_step`` runs them after its encodes, the loss drawing
    from ``split(fold_in(key, step))``'s second key) and the port's one
    process: loss, grad_norm, parameters and moments (STEP_RTOL,
    MOMENT_REL, JAX_REL)."""
    jcfg, tcfg = jcdit.tiny_config(**COG_KW), tcdit.tiny_config(**COG_KW)
    params = jcdit.init_cogvideox_dit(jax.random.key(7), jcfg)
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**OCFG))
    tc = jcog.CogTrainerConfig(compute_dtype=jnp.float32, remat=False,
                               attn_impl="xla")
    batches = _cog_batches()
    key = jax.random.key(3)
    jmesh = _jmesh(dict(dp=2, fsdp=2))

    def step_fn(state, batch, k_loss):
        def loss_fn(p):
            return jcog.cog_vpred_loss(
                jcfg, tc, p, batch["video_latents"],
                batch["first_frame_latent"], batch["traj_latents"],
                batch["id_latent"], batch["prompt_embeds"], k_loss,
                mesh=jmesh)
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        grads = jsharding.constrain_like_params(grads, jmesh)
        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params)
        return jtrainer.TrainState(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt_state, step=state.step + 1), (
            loss, optax.global_norm(grads))

    draws, metrics = [], []
    with jmesh:
        state = _replicated_leaves(jtrainer.make_sharded_train_state(
            jax.tree.map(jnp.array, params), opt, jmesh), jmesh)
        step = jax.jit(step_fn)
        for i, b in enumerate(batches):
            k_loss = jax.random.split(jax.random.fold_in(key, i))[1]
            k_t, k_n = jax.random.split(k_loss)
            draws.append({"t": np.array(jax.random.randint(
                k_t, (B,), 0, 1000)).astype(np.int64),
                "noise": np.array(jax.random.normal(
                    k_n, b["video_latents"].shape, jnp.float32))})
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                            k_loss)
            metrics.append([float(m[0]), float(m[1])])
    sd = {k: v.numpy() for k, v in cogvideox_dit_from_jax(
        jax.tree.map(np.asarray, params), tcfg).items()}
    pool.run(W.train_steps, tmp_path, dict(dp=2, fsdp=2), "cog", COG_KW, sd,
             batches, draws, OCFG, True)
    got = dict(np.load(tmp_path / "train.npz"))
    np.testing.assert_allclose(got["metrics"], metrics, rtol=1e-4)
    want = cogvideox_dit_from_jax(jax.tree.map(np.asarray, state.params),
                                  tcfg)
    moments = {s: cogvideox_dit_from_jax(jax.tree.map(
        np.asarray, _slot(state.opt_state, s)), tcfg) for s in ("mu", "nu")}
    for name, start in sd.items():
        assert _rel(got[f"param/{name}"] - start,
                    want[name].numpy() - start) <= JAX_REL, name
        for slot in ("mu", "nu"):
            assert _rel(got[f"{slot}/{name}"], moments[slot][name].numpy()) \
                <= JAX_REL, (slot, name)
    # the port's one process
    model = tcdit.CogVideoXDiT(tcfg, device="meta")
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in sd.items()}, assign=True)
    one = ttrainer.init_train_state(model, toptim.OptimizerConfig(**OCFG))
    ref = []
    for b, d in zip(batches, draws):
        m = tcog.cog_train_step(
            one, None, tcog.CogTrainerConfig(compute_dtype=torch.float32,
                                             remat=False),
            {k: torch.from_numpy(v.copy()) for k, v in b.items()},
            draws={k: torch.from_numpy(v) for k, v in d.items()})
        ref.append([float(m["loss"]), float(m["grad_norm"])])
    _check_against_one_process(got, one, np.array(ref))


@pytest.mark.parametrize("mesh_kw", [dict(dp=2, fsdp=2), dict(fsdp=4)],
                         ids=_ids)
def test_indivisible_batch_runs_the_dp_slice_on_every_fsdp_rank(
        pool, tmp_path, mesh_kw):
    """A global batch of 2 at dp 2 x fsdp 2 and at fsdp 4 (JAX's fallback
    case: dp x fsdp does not divide it, and JAX runs XLA attention where
    the port runs K6): every fsdp rank runs its dp slice whole and the
    step equals the port's one process on the same draws (STEP_RTOL,
    MOMENT_REL)."""
    sd = {k: v.numpy() for k, v in tdit.init_wan_dit(
        tdit.tiny_config(**WAN_KW),
        torch.Generator().manual_seed(4)).state_dict().items()}
    batches = _wan_batches(seed=2, batch=2)
    rs = np.random.RandomState(3)
    draws = [(rs.randint(0, 1000, 2), rs.randn(2, 4, 3, 8, 8).astype(
        np.float32)) for _ in range(2)]
    pool.run(W.train_steps, tmp_path, mesh_kw, "wan", WAN_KW, sd, batches,
             draws, OCFG)
    got = dict(np.load(tmp_path / "train.npz"))
    state, metrics = _one_process(sd, batches, draws)
    _check_against_one_process(got, state, metrics)


@pytest.mark.parametrize("fault,mesh_kw", [
    ("sum_not_mean", dict(dp=2, fsdp=2)), ("local_norm", dict(dp=2, fsdp=2)),
    ("tp_grad_unreduced", dict(fsdp=2, tp=2))])
def test_planted_faults_read_over_the_limits(pool, tmp_path, fault,
                                             mesh_kw):
    """The faults ``chip_smoke.py`` plants in its train meshes, each
    against the port's one process: the gradients summed over the batch
    ranks instead of averaged (grad_norm x 4), grad_norm from the rank's
    own slices (no all-reduce), the tp-replicated norms' gradients left
    un-reduced (``copy_to_tp`` as the identity: the cross-attention
    LayerNorm's moments). Each reads over the limit that the unfaulted
    step keeps (STEP_RTOL, MOMENT_REL)."""
    sd = {k: v.numpy() for k, v in tdit.init_wan_dit(
        tdit.tiny_config(**WAN_KW),
        torch.Generator().manual_seed(6)).state_dict().items()}
    batches = _wan_batches(seed=8)
    rs = np.random.RandomState(9)
    draws = [(rs.randint(0, 1000, B), rs.randn(B, 4, 3, 8, 8).astype(
        np.float32)) for _ in range(2)]
    pool.run(W.train_steps, tmp_path, mesh_kw, "wan", WAN_KW, sd, batches,
             draws, OCFG, False, fault)
    got = dict(np.load(tmp_path / "train.npz"))
    state, metrics = _one_process(sd, batches, draws)
    gn = np.abs(got["metrics"][:, 1] / metrics[:, 1] - 1)
    if fault == "tp_grad_unreduced":
        name = "blocks.0.norm2.weight"
        err = _rel(got[f"mu/{name}"], state.optimizer.mu[name].numpy())
        assert err > MOMENT_REL * 100, err
        assert gn.max() > STEP_RTOL * 100
    else:
        assert gn.min() > STEP_RTOL * 1000, gn
    np.testing.assert_allclose(got["metrics"][:, 0], metrics[:, 0],
                               rtol=STEP_RTOL)


def _opt_tensors(seed):
    """Whole tensors under DiT names whose rules cut them over fsdp (and
    adafactor's factored shapes: two dims of at least 128)."""
    rs = np.random.RandomState(seed)
    shapes = {"blocks.0.attn1.to_q.weight": (256, 192),
              "blocks.0.ffn.net.2.weight": (128, 320),
              "blocks.0.attn1.to_q.bias": (256,),
              "proj_out.weight": (16, 256)}
    return {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("rule", ["adafactor", "prodigy"])
def test_optimizer_rules_on_shards_match_optax(pool, tmp_path, rule):
    """adafactor and prodigy (with the clip) on fsdp 2 slices, two steps
    on given gradients (the second over the clip's norm): the gathered
    parameters == optax's chain (``frameino_tpu.training.optim``) on the
    whole tensors and == the port's optimizer on the whole tensors, 1e-5
    relative (fp32; the sums complete over the ranks in another order)."""
    ocfg = dict(optimizer=rule, learning_rate=1e-2 if rule == "adafactor"
                else 1.0, lr_scheduler="constant", max_grad_norm=50.0)
    params = _opt_tensors(0)
    grads = [{n: g * s for n, g in _opt_tensors(i + 1).items()}
             for i, s in enumerate((0.05, 1.0))]
    pool.run(W.optimizer_shards, tmp_path, dict(fsdp=2), ocfg, params,
             grads)
    got = dict(np.load(tmp_path / "opt.npz"))
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**ocfg))
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    jstate = opt.init(jp)
    whole = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    topt = toptim.make_optimizer(toptim.OptimizerConfig(**ocfg), whole)
    for i, g in enumerate(grads):
        upd, jstate = opt.update({n: jnp.asarray(a) for n, a in g.items()},
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(whole, {n: torch.from_numpy(a) for n, a in g.items()})
        for n in params:
            np.testing.assert_allclose(got[f"{i}/{n}"], np.asarray(jp[n]),
                                       rtol=1e-5, atol=1e-6, err_msg=n)
            np.testing.assert_allclose(got[f"{i}/{n}"], whole[n].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# checkpoints and the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["adamw", "adafactor"])
def test_sharded_checkpoint_restores_on_one_process_and_another_mesh(
        pool, tmp_path, rule):
    """A state trained a step at dp 2 x fsdp 2 and saved (gathered to the
    mesh's rank 0, the single-process format) restores bit-equal into one
    process and into fsdp 4 (gathered again): the parameters and every
    optimizer slot (adafactor's factored rows and columns cut as their
    parameter's other dim)."""
    ocfg = dict(OCFG, optimizer=rule)
    sd = {k: v.numpy() for k, v in tdit.init_wan_dit(
        tdit.tiny_config(**WAN_KW),
        torch.Generator().manual_seed(5)).state_dict().items()}
    batch = _wan_batches(seed=4, n=1)[0]
    rs = np.random.RandomState(5)
    draws = (rs.randint(0, 1000, B), rs.randn(B, 4, 3, 8, 8).astype(
        np.float32))
    pool.run(W.checkpoint_round, tmp_path, dict(dp=2, fsdp=2), WAN_KW, sd,
             batch, draws, ocfg, True)
    pool.run(W.checkpoint_round, tmp_path, dict(fsdp=4), WAN_KW, sd, batch,
             draws, ocfg, False)
    saved = dict(np.load(tmp_path / "state_dp2xfsdp2.npz"))
    other = dict(np.load(tmp_path / "state_fsdp4.npz"))
    assert saved.keys() == other.keys()
    for k in saved:
        np.testing.assert_array_equal(other[k], saved[k], err_msg=k)
    model = tdit.WanDiT(tdit.tiny_config(**WAN_KW), device="meta")
    model.load_state_dict({k: torch.zeros(v.shape) for k, v in sd.items()},
                          assign=True)
    state = ttrainer.init_train_state(model, toptim.OptimizerConfig(**ocfg))
    ckpt = tmp_path / "ckpt" / "checkpoint-1"
    _, meta = restore_checkpoint(str(ckpt), state)
    assert meta == {"x": 1} and state.step == 1 == state.optimizer.count
    assert {k.split("/")[0] for k in saved if "/" in k} == {
        "param", *state.optimizer.slots}
    if rule == "adafactor":
        assert any(t.numel() and t.dim() == 1
                   for t in state.optimizer.v_row.values())
    for name, p in state.params().items():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      saved[f"param/{name}"], err_msg=name)
        for slot in state.optimizer.slots:
            np.testing.assert_array_equal(
                getattr(state.optimizer, slot)[name].numpy(),
                saved[f"{slot}/{name}"], err_msg=name)


def test_wan_pipeline_fsdp2_matches_unsharded(pool, tmp_path):
    """The tiny Wan pipeline at fsdp 2 (each rank's slices gathered block
    by block in the no-grad forward, the CFG batch of 2 cut over fsdp) ==
    the port's unsharded pipeline, fp32; only rank 0 returns the
    video."""
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
    pool.run(W.pipeline, tmp_path, dict(fsdp=2), WAN_KW, vae_cfg, inputs,
             kw)
    got = np.load(tmp_path / "video_0.npy")
    assert not (tmp_path / "video_1.npy").exists()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_tp_dim_and_fsdp_rules_name_every_cut():
    """The Wan tiny DiT at fsdp 2 x tp 2: the cuts the model records are
    the rules' (``tp_dim``, ``fsdp_dim``), and a block's fsdp-cut tensors
    are the ones it gathers."""
    mesh = Mesh(MeshConfig(fsdp=2, tp=2), 0)
    model = tdit.WanDiT(tdit.tiny_config(**WAN_KW), device="meta",
                        mesh=mesh)
    for name, c in model.cuts.items():
        assert c.tp_dim == tp_dim(name)
    gathered = dict(model._fsdp["blocks.0."])
    assert gathered["attn1.to_q.weight"] == 1
    assert gathered["ffn.net.2.weight"] == 0
    assert "attn1.to_q.bias" not in gathered
    assert dataclasses.is_dataclass(model.cuts["proj_out.weight"])
