"""Multi-process runtime and sharding rules over ``torch.distributed``
(counterpart of ``frameino_tpu/parallel/``): ``multihost`` starts and
checks the processes, ``sharding`` cuts the DiT's parameters for a
``core.meshes.Mesh``. Only dp x tp meshes are ported."""
