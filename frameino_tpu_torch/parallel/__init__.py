"""Multi-process runtime and sharding rules over ``torch.distributed``
(counterpart of ``frameino_tpu/parallel/``): ``multihost`` starts and
checks the processes, ``sharding`` cuts the DiTs' parameters for a
``core.meshes.Mesh``, ``collectives`` the collectives autograd sees. dp
x fsdp x tp x sp meshes are ported; pp is not."""
