"""Worker side of ``tests/test_torch_parallel.py``: each function runs in
one of the gloo processes that ``spawn`` starts, imports only torch and
the port (never jax), and saves what it computed as ``.npy`` files in the
test's directory for the test process to compare with JAX.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from frameino_tpu_torch.core.meshes import MeshConfig, make_mesh
from frameino_tpu_torch.models import wan_dit as tdit
from frameino_tpu_torch.models import wan_vae as tvae
from frameino_tpu_torch.models.weights import wan_dit_from_jax
from frameino_tpu_torch.ops import attention as tattn
from frameino_tpu_torch.parallel import multihost
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


def _save(tmp, name, rank, x):
    np.save(os.path.join(tmp, f"{name}_{rank}.npy"),
            x.float().numpy() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def attention(rank, tmp, mesh_kw, q_raw, k_raw, v, w_q, w_k, cos, sin, H,
              eps):
    """The rank's slices of the global inputs through
    ``fused_qk_flash_attention_sharded``."""
    mesh = make_mesh(MeshConfig(**mesh_kw))
    bl, hl = q_raw.shape[0] // mesh.dp, H // mesh.tp
    D = v.shape[-1]
    b = slice(mesh.dp_rank * bl, (mesh.dp_rank + 1) * bl)
    h = slice(mesh.tp_rank * hl, (mesh.tp_rank + 1) * hl)
    hd = slice(h.start * D, h.stop * D)
    out = tattn.fused_qk_flash_attention_sharded(
        _t(q_raw[b, :, hd]), _t(k_raw[b, :, hd]), _t(v[b, h]), _t(w_q[hd]),
        _t(w_k[hd]), _t(cos), _t(sin), mesh, num_heads=H, eps=eps)
    _save(tmp, "attn", rank, out)


def dit(rank, tmp, mesh_kw, dit_kw, params_np, x, t, ctx, mask):
    """The rank's slice of the bridged JAX weights in a sharded WanDiT;
    the forward with the text projected in the forward and hoisted."""
    mesh = make_mesh(MeshConfig(**mesh_kw))
    cfg = tdit.tiny_config(**dit_kw)
    model = tdit.WanDiT(cfg, device="meta", mesh=mesh)
    model.load_state_dict(wan_dit_from_jax(params_np, cfg, mesh),
                          assign=True)
    model.eval()
    x, t, ctx, mask = (_t(a) for a in (x, t, ctx, mask))
    _save(tmp, "dit", rank, model(x, t, ctx, timestep_mask=mask))
    kv = model.precompute_text_kv(ctx)
    _save(tmp, "dit_kv", rank, model(x, t, timestep_mask=mask, text_kv=kv))
    assert kv[0][0].shape[1] == cfg.num_attention_heads // mesh.tp


def pipeline(rank, tmp, mesh_kw, dit_kw, vae_cfg, inputs, kw):
    """The seeded tiny pipeline on the mesh: the DiT is the rank's slice
    of the same seeded init, the VAE lives on rank 0 only."""
    mesh = make_mesh(MeshConfig(**mesh_kw))
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
