"""Worker side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_sp.py``: each function runs in the gloo processes that
``spawn`` starts for it, or in those of a ``Pool`` that runs one job after
another; it imports only torch and the port (never jax), lays its mesh
over the first processes (``_mesh``), returns at once in a process outside
it, and saves what it computed as ``.npy`` files in the test's directory
for the test process to compare with JAX.
"""

import datetime
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from frameino_tpu_torch.core.meshes import MeshConfig, make_mesh
from frameino_tpu_torch.models import cogvideox_dit as tcdit
from frameino_tpu_torch.models import cogvideox_vae as tcvae
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import (cogvideox_dit_from_jax,
                                               wan_dit_from_jax)
from frameino_tpu_torch.ops import attention as tattn
from frameino_tpu_torch.parallel import multihost
from frameino_tpu_torch.pipelines import cogvideox_i2v as tcpipe
from frameino_tpu_torch.pipelines import wan_i2v as tpipe


def spawn(fn, world: int, tmp, *args):
    """Run ``fn(rank, tmp, *args)`` in ``world`` processes
    joined over gloo by a file in ``tmp`` (no port to collide under
    pytest-xdist)."""
    mp.spawn(_entry, args=(fn, world, str(tmp), args), nprocs=world,
             join=True)


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    multihost.initialize(f"file://{os.path.join(tmp, 'pg')}", world, rank,
                         backend="gloo")
    try:
        fn(rank, tmp, *args)
    finally:
        dist.destroy_process_group()


# the meshes the current job made in this process (their groups are freed
# after it)
_MESHES = []


def _mesh(mesh_kw):
    """The job's mesh laid over the first processes of the default group,
    or None in a process outside it."""
    cfg = MeshConfig(**mesh_kw)
    mesh = make_mesh(cfg, ranks=range(cfg.size))
    if mesh is not None:
        _MESHES.append(mesh)
    return mesh


class Pool:
    """``world`` gloo processes started once (each start imports torch
    and the port: seconds), which then run jobs one after another: every
    process runs each job's ``fn(rank, tmp, *args)``. A failed job (an
    exception in any process, or no answer within ``timeout`` seconds)
    raises and leaves the pool ``broken``: its processes may be out of
    step."""

    def __init__(self, world: int, tmp, timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        self.timeout = timeout
        self.broken = False
        self.jobs = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_pool_loop, daemon=True, args=(
            r, world, os.path.join(str(tmp), "pool_pg"), self.jobs[r],
            self.results)) for r in range(world)]
        for proc in self.procs:
            proc.start()

    def run(self, fn, tmp, *args):
        for q in self.jobs:
            q.put((fn, str(tmp), args))
        errors = []
        try:
            for _ in self.procs:
                rank, err = self.results.get(timeout=self.timeout)
                if err is not None:
                    errors.append(f"process {rank}:\n{err}")
        except Exception as e:         # queue.Empty: a process hangs
            errors.append(f"no answer within {self.timeout} s ({e!r})")
        if errors:
            self.broken = True
            raise RuntimeError("\n".join(errors))

    def close(self):
        for q in self.jobs:
            q.put(None)
        for proc in self.procs:
            proc.join(timeout=10 if not self.broken else 1)
            if proc.is_alive():
                proc.terminate()


def _pool_loop(rank, world, pg_path, jobs, results):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_path}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        while (job := jobs.get()) is not None:
            fn, tmp, args = job
            err = None
            try:
                fn(rank, tmp, *args)
            except BaseException:
                err = traceback.format_exc()
            for m in _MESHES:
                for g in m.groups():
                    dist.destroy_process_group(g)
            _MESHES.clear()
            results.put((rank, err))
    finally:
        dist.destroy_process_group()


def _save(tmp, name, rank, x):
    np.save(os.path.join(tmp, f"{name}_{rank}.npy"),
            x.float().numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def attention(rank, tmp, mesh_kw, q_raw, k_raw, v, w_q, w_k, cos, sin, H,
              eps):
    """The rank's slices of the global inputs through
    ``fused_qk_flash_attention_sharded``."""
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    bl, hl = q_raw.shape[0] // mesh.dp, H // mesh.tp
    D = v.shape[-1]
    b = slice(mesh.dp_rank * bl, (mesh.dp_rank + 1) * bl)
    h = slice(mesh.tp_rank * hl, (mesh.tp_rank + 1) * hl)
    hd = slice(h.start * D, h.stop * D)
    out = tattn.fused_qk_flash_attention_sharded(
        _t(q_raw[b, :, hd]), _t(k_raw[b, :, hd]), _t(v[b, h]), _t(w_q[hd]),
        _t(w_k[hd]), _t(cos), _t(sin), mesh, num_heads=H, eps=eps)
    _save(tmp, "attn", rank, out)


def dit(rank, tmp, mesh_kw, dit_kw, params_np, x, t, ctx, mask,
        sp_method="allgather"):
    """The rank's slice of the bridged JAX weights in a sharded WanDiT;
    the forward with the text projected in the forward and hoisted (sp
    meshes: the keys gathered over sp, or ``sp_method`` "ring")."""
    tattn.DEFAULT_SP_METHOD = sp_method
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    cfg = tdit.tiny_config(**dit_kw)
    model = tdit.WanDiT(cfg, device="meta", mesh=mesh)
    model.load_state_dict(wan_dit_from_jax(params_np, cfg, mesh),
                          assign=True)
    model.eval()
    x, t, ctx = (_t(a) for a in (x, t, ctx))
    mask = None if mask is None else _t(mask)
    _save(tmp, "dit", rank, model(x, t, ctx, timestep_mask=mask))
    kv = model.precompute_text_kv(ctx)
    _save(tmp, "dit_kv", rank, model(x, t, timestep_mask=mask, text_kv=kv))
    assert kv[0][0].shape[1] == cfg.num_attention_heads // mesh.tp


def ln_attention(rank, tmp, mesh_kw, q_raw, k_raw, v, w_q, b_q, w_k, b_k,
                 cos, sin, H, eps):
    """The rank's slices of the global inputs through
    ``fused_ln_qk_flash_attention_sharded``."""
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    b, h, hd = _slices(mesh, q_raw.shape[0], H, v.shape[-1])
    out = tattn.fused_ln_qk_flash_attention_sharded(
        _t(q_raw[b, :, hd]), _t(k_raw[b, :, hd]), _t(v[b, h]), _t(w_q),
        _t(b_q), _t(w_k), _t(b_k), _t(cos), _t(sin), mesh, num_heads=H,
        eps=eps)
    _save(tmp, "attn", rank, out)


def _slices(mesh, B, H, D):
    """The rank's batch, head and head-column slices."""
    bl, hl = B // mesh.dp, H // mesh.tp
    b = slice(mesh.dp_rank * bl, (mesh.dp_rank + 1) * bl)
    h = slice(mesh.tp_rank * hl, (mesh.tp_rank + 1) * hl)
    return b, h, slice(h.start * D, h.stop * D)


def sp_attention(rank, tmp, mesh_kw, q, k, v, gather_kv, sp_method):
    """The rank's batch, head and sequence shard of global [B, H, S, D]
    q (and k/v with ``gather_kv``; their whole sequence without it)
    through ``dispatch_attention``; at "ring", also with one head a chunk
    (saved as ``ring_chunk1``)."""
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    b, h, _ = _slices(mesh, q.shape[0], q.shape[1], 1)
    n = q.shape[2] // mesh.sp
    s = slice(mesh.sp_rank * n, (mesh.sp_rank + 1) * n)
    ql = _t(q[b, h, s])
    kl, vl = (_t(a[b, h, s] if gather_kv else a[b, h]) for a in (k, v))
    out = tattn.dispatch_attention(ql, kl, vl, mesh=mesh, gather_kv=gather_kv,
                                   sp_method=sp_method)
    _save(tmp, "attn", rank, out)
    if sp_method == "ring":
        # a score budget under one head's scores: one head a chunk
        budget, tattn.RING_SCORE_BYTES = tattn.RING_SCORE_BYTES, 1
        try:
            assert tattn.ring_head_chunk(*ql.shape[:3], kl.shape[2]) == 1
            _save(tmp, "ring_chunk1", rank,
                  tattn.ring_attention(ql, kl, vl, mesh))
        finally:
            tattn.RING_SCORE_BYTES = budget


def cog_dit(rank, tmp, mesh_kw, cfg_kw, params_np, x, text, t, rope,
            sp_method="allgather"):
    """The rank's slice of the bridged JAX weights in a sharded
    CogVideoXDiT, one forward (rope: the video tokens' (cos, sin), or None
    for the 2B)."""
    tattn.DEFAULT_SP_METHOD = sp_method
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    cfg = tcdit.tiny_config(**cfg_kw)
    model = tcdit.CogVideoXDiT(cfg, device="meta", mesh=mesh)
    model.load_state_dict(cogvideox_dit_from_jax(params_np, cfg, mesh),
                          assign=True, strict=True)
    model.eval()
    out = model(_t(x), _t(text), _t(t),
                None if rope is None else tuple(_t(a) for a in rope))
    _save(tmp, "dit", rank, out)


def cog_pipeline(rank, tmp, mesh_kw, cfg_kw, vae_cfg, inputs, kw):
    """The seeded tiny CogVideoX pipeline on the mesh: the DiT is the
    rank's slice of the same seeded init, the VAE lives on rank 0 only."""
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    gen = torch.Generator().manual_seed(11)
    dit = tcdit.init_cogvideox_dit(tcdit.tiny_config(**cfg_kw), gen,
                                   mesh=mesh)
    vae = tcvae.init_cogvideox_vae(vae_cfg, gen) if rank == 0 else None
    pipe = tcpipe.CogVideoXImageToVideoPipeline(dit, vae, mesh=mesh)
    image, traj, idf, text, latents = (_t(a) for a in inputs)
    # only rank 0's noise and conditions are used
    video = pipe(image if rank == 0 else None, prompt_embeds=text,
                 traj_tensor=traj if rank == 0 else None,
                 id_tensor=idf if rank == 0 else None,
                 latents=latents if rank == 0 else None, **kw)
    assert (video is None) == (rank != 0)
    if video is not None:
        _save(tmp, "video", rank, video)


def mesh_layout(rank, tmp):
    """A tp = 2 x sp = 2 mesh over the 4 processes and an sp = 2 mesh over
    the first 2 (``ranks=``): each process's mesh rank, coordinates and
    the default-group ranks of its tp, dp and sp groups (-1 outside the
    mesh)."""
    rows = []
    for kw, ranks in ((dict(tp=2, sp=2), None), (dict(sp=2), [0, 1])):
        mesh = make_mesh(MeshConfig(**kw), ranks=ranks)
        if mesh is None:
            rows.append([-1] * 10)
            continue
        c = mesh.coords
        groups = [dist.get_process_group_ranks(g) for g in (
            mesh.tp_group, mesh.dp_group, mesh.sp_group)]
        rows.append([mesh.rank, c["dp"], c["tp"], c["sp"]]
                    + [g[0] for g in groups] + [g[-1] for g in groups])
        # every mesh's collectives run over its own groups only
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=mesh.sp_group)
        assert t.item() == sum(groups[2])
    _save(tmp, "layout", rank, np.array(rows))


def pipeline(rank, tmp, mesh_kw, dit_kw, vae_cfg, inputs, kw):
    """The seeded tiny pipeline on the mesh: the DiT is the rank's slice
    of the same seeded init, the VAE lives on rank 0 only."""
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    gen = torch.Generator().manual_seed(0)
    dit = tdit.init_wan_dit(tdit.tiny_config(**dit_kw), gen, mesh=mesh)
    vae = tvae.init_wan_vae(vae_cfg, gen) if rank == 0 else None
    pipe = tpipe.WanImageToVideoPipeline(dit, vae, mesh=mesh)
    image, text, traj, ids, latents = (_t(a) for a in inputs)
    # only rank 0's noise and conditions are used
    video = pipe(image, prompt_embeds=text, traj_tensor=traj, id_tensor=ids,
                 latents=latents if rank == 0 else None, **kw)
    assert (video is None) == (rank != 0)
    if video is not None:
        _save(tmp, "video", rank, video)


def multihost_helpers(rank, tmp):
    """broadcast_from_rank0 (None entries, another rank's dtype) and
    assert_same_across_processes passing and failing on every rank; the
    worker process holds no jax module."""
    import sys
    assert not [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "frameino_tpu."))]
    make_mesh(MeshConfig(dp=2))
    mine = [torch.full((2, 3), float(rank + 1)), None,
            torch.arange(4, dtype=torch.int64) * (rank + 1)]
    got = multihost.broadcast_from_rank0(mine if rank == 0 else [None] * 3,
                                         torch.device("cpu"))
    assert got[1] is None
    assert torch.equal(got[0], torch.ones(2, 3))
    assert torch.equal(got[2], torch.arange(4))
    multihost.assert_same_across_processes(0.5)
    try:
        multihost.assert_same_across_processes(float(rank))
    except AssertionError as e:
        _save(tmp, "diverged", rank, np.array([str(e).startswith(
            "cross-process divergence")]))
    try:
        make_mesh(MeshConfig(dp=4))
    except ValueError:
        _save(tmp, "bad_size", rank, np.array([True]))


def _gathered_state(state, mesh):
    """The train state's parameters and optimizer slots, whole (gathered
    over the mesh), as numpy, with the step's metrics added by the
    caller."""
    from frameino_tpu_torch.parallel.sharding import gather_state_dict
    opt = state.optimizer
    out = {f"param/{n}": t for n, t in gather_state_dict(
        state.params(), mesh, opt.cuts).items()}
    for slot in opt.slots:
        tensors = getattr(opt, slot)
        out.update({f"{slot}/{n}": t for n, t in gather_state_dict(
            tensors, mesh, {n: opt.slot_cut(slot, n)
                            for n in tensors}).items()})
    return {k: v.detach().float().numpy() for k, v in out.items()}


def train_steps(rank, tmp, mesh_kw, family, cfg_kw, sd_np, batches, draws,
                ocfg, local_batch=False, fault=None):
    """The port's sharded train step on the mesh, from the whole state
    dict ``sd_np`` (Wan or CogVideoX tiny config), over the global
    ``batches`` (latents) with the given ``draws`` a step: each step's
    loss and grad_norm, then the whole parameters and optimizer state,
    saved by mesh rank 0 as ``train.npz``. ``local_batch``: hand each rank
    only its examples. ``fault``: a planted fault of the checks
    ("sum_not_mean", "local_norm", "tp_grad_unreduced")."""
    from frameino_tpu_torch.parallel import collectives
    from frameino_tpu_torch.parallel.sharding import batch_slice
    from frameino_tpu_torch.training import cog_trainer, optim, trainer
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    sd = {k: _t(v) for k, v in sd_np.items()}
    if family == "wan":
        model = tdit.WanDiT(tdit.tiny_config(**cfg_kw), device="meta")
    else:
        model = tcdit.CogVideoXDiT(tcdit.tiny_config(**cfg_kw),
                                   device="meta")
    model.load_state_dict(sd, assign=True)
    state = trainer.init_train_state(model, optim.OptimizerConfig(**ocfg),
                                     mesh=mesh)
    assert state.model.mesh is mesh
    metrics = []
    saved = (trainer.reduce_gradients, optim.sharded_global_norm,
             collectives.copy_to_tp)
    try:
        if fault == "sum_not_mean":
            def summed(grads, cuts, m):
                saved[0](grads, cuts, m)
                for g in grads.values():
                    g.mul_(m.batch)
            trainer.reduce_gradients = summed
        elif fault == "local_norm":
            optim.sharded_global_norm = lambda g, cuts, m: optim.global_norm(
                g.values())
        elif fault == "tp_grad_unreduced":
            for mod in (tdit, tcdit):
                mod.copy_to_tp = lambda x, group: x
        for i, (batch, d) in enumerate(zip(batches, draws)):
            B = batch["video_latents"].shape[0]
            tb = {k: None if v is None else _t(v) for k, v in batch.items()}
            if local_batch:
                sl, _ = batch_slice(mesh, B)
                tb = {k: None if v is None else v[sl] for k, v in tb.items()}
            if family == "wan":
                m = trainer.train_step(
                    state, None, trainer.TrainerConfig(
                        compute_dtype=torch.float32, remat=bool(i % 2)),
                    tb, seed=0, draws=tuple(_t(a) for a in d), batch_size=B)
            else:
                m = cog_trainer.cog_train_step(
                    state, None, cog_trainer.CogTrainerConfig(
                        compute_dtype=torch.float32, remat=bool(i % 2)),
                    tb, draws={k: _t(v) for k, v in d.items()},
                    batch_size=B)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
    finally:
        trainer.reduce_gradients, optim.sharded_global_norm = saved[:2]
        tdit.copy_to_tp = tcdit.copy_to_tp = saved[2]
    out = _gathered_state(state, mesh)
    if mesh.rank == 0:
        np.savez(os.path.join(tmp, "train.npz"), metrics=np.array(metrics),
                 **out)


def mesh_layout_fsdp(rank, tmp):
    """dp 2 x fsdp 2 and fsdp 2 x tp 2 meshes over the 4 processes: each
    process's mesh rank, coordinates (dp, fsdp, tp, sp), batch rank and
    the default-group ranks of its fsdp and batch groups; an all-reduce
    over each group sums its members."""
    rows = []
    for kw in (dict(dp=2, fsdp=2), dict(fsdp=2, tp=2)):
        mesh = _mesh(kw)
        c = mesh.coords
        fs, bt = (dist.get_process_group_ranks(g)
                  for g in (mesh.fsdp_group, mesh.batch_group))
        for g, members in ((mesh.fsdp_group, fs), (mesh.batch_group, bt)):
            t = torch.tensor([float(rank)])
            dist.all_reduce(t, group=g)
            assert t.item() == sum(members)
        rows.append([mesh.rank, c["dp"], c["fsdp"], c["tp"], c["sp"],
                     mesh.batch_rank] + fs + bt + [-1] * (4 - len(bt)))
        for g in mesh.groups():
            dist.destroy_process_group(g)
        _MESHES.remove(mesh)
    _save(tmp, "layout", rank, np.array(rows))


def checkpoint_round(rank, tmp, mesh_kw, cfg_kw, sd_np, batch, draws, ocfg,
                     save):
    """At ``save``: one AdamW step of the tiny Wan DiT on the mesh from
    ``sd_np``, then ``save_checkpoint`` under ``tmp/ckpt``; otherwise a
    fresh state on the mesh restored from that checkpoint. Either way the
    gathered state is saved by mesh rank 0 (``state_<mesh>.npz``, with the
    optimizer's count)."""
    from frameino_tpu_torch.core.checkpoint import (latest_checkpoint,
                                                    restore_checkpoint,
                                                    save_checkpoint)
    from frameino_tpu_torch.training import optim, trainer
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    model = tdit.WanDiT(tdit.tiny_config(**cfg_kw), device="meta")
    model.load_state_dict({k: _t(v) for k, v in sd_np.items()}, assign=True)
    state = trainer.init_train_state(model, optim.OptimizerConfig(**ocfg),
                                     mesh=mesh)
    root = os.path.join(tmp, "ckpt")
    if save:
        trainer.train_step(
            state, None, trainer.TrainerConfig(compute_dtype=torch.float32,
                                               remat=False),
            {k: _t(v) for k, v in batch.items()}, seed=0,
            draws=tuple(_t(a) for a in draws))
        save_checkpoint(root, state.step, state, metadata={"x": 1})
    else:
        _, meta = restore_checkpoint(latest_checkpoint(root), state)
        assert meta == {"x": 1}
    out = _gathered_state(state, mesh)
    if mesh.rank == 0:
        tag = "x".join(f"{k}{v}" for k, v in mesh_kw.items())
        np.savez(os.path.join(tmp, f"state_{tag}.npz"),
                 count=np.array([state.optimizer.count, state.step]), **out)


def optimizer_shards(rank, tmp, mesh_kw, ocfg, params_np, grads_np):
    """The port's optimizer on the rank's slices of whole ``params_np``
    (laid out by the DiT rules of their names), stepped once per entry of
    ``grads_np`` with the slices of those whole gradients; the whole
    parameters after each step, saved by mesh rank 0 as ``opt.npz``."""
    from frameino_tpu_torch.parallel.sharding import (gather_tensor,
                                                      layout, shard_tensor)
    from frameino_tpu_torch.training import optim
    mesh = _mesh(mesh_kw)
    if mesh is None:
        return
    cuts = layout({n: a.shape for n, a in params_np.items()}, mesh)
    assert any(c.fsdp_dim is not None for c in cuts.values())
    params = {n: shard_tensor(_t(a), cuts[n], mesh).clone()
              for n, a in params_np.items()}
    opt = optim.make_optimizer(optim.OptimizerConfig(**ocfg), params, cuts,
                               mesh)
    out = {}
    for i, grads in enumerate(grads_np):
        opt.step(params, {n: shard_tensor(_t(a), cuts[n], mesh)
                          for n, a in grads.items()})
        for n, p in params.items():
            out[f"{i}/{n}"] = gather_tensor(p, cuts[n], mesh).numpy().copy()
    if mesh.rank == 0:
        np.savez(os.path.join(tmp, "opt.npz"), **out)


def train_entry(rank, world, tmp, argv, port):
    """``train.main(argv)`` as one of ``world`` torchrun processes (its
    environment set here, gloo on the CPU), recording how many examples
    each collate took; saves the counts and the summary's history."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from frameino_tpu_torch import train
    from frameino_tpu_torch.training import cli
    sizes = []
    collate = cli.collate

    def counted(items, *a, **kw):
        sizes.append(len(items))
        return collate(items, *a, **kw)
    cli.collate = counted
    try:
        out = train.main(argv)
    finally:
        cli.collate = collate
        dist.destroy_process_group()
    np.save(os.path.join(tmp, f"collated_{rank}.npy"), np.array(sizes))
    np.save(os.path.join(tmp, f"history_{rank}.npy"), np.array(
        [[h["loss"], h["grad_norm"]] for h in out["history"]]))
    np.save(os.path.join(tmp, f"mesh_{rank}.npy"), np.array(
        [out["mesh"].dp, out["mesh"].fsdp, out["mesh"].tp]))
