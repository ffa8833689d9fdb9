"""Multi-process runtime and sharding rules over ``torch.distributed``
(counterpart of ``frameino_tpu/parallel/``): ``multihost`` starts and
checks the processes, ``sharding`` cuts the DiTs' parameters for a
``core.meshes.Mesh``. dp x tp x sp meshes are ported; fsdp and pp are
not."""
