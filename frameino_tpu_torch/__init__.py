"""FrameINO on PyTorch and CUDA: a port of ``frameino_tpu`` for NVIDIA
Hopper (H100), beside the JAX package, which stays the reference.

The first slice is Wan2.2-TI2V-5B FrameINO serving: the HTTP server
(``app/server.py``, entry point ``serve.py``), the pipeline
(``pipelines/wan_i2v.py``), the Wan2.2 VAE (``models/wan_vae.py``), the
FlowMatch-Euler scheduler and the 5B DiT (``models/wan_dit.py``). Its three
attention kernels are written by hand for sm_90a (``ops/attention.py``,
``csrc/flash_fwd.cu``, ``csrc/qk_producers.cu``). Later slices add
CogVideoX-5B-I2V serving, Wan2.2 training, int8 w8a8 DiT serving
(``models/quant.py``, K7 in ``csrc/dyn_quant.cu``) and Wan2.2 serving over
a dp x tp process mesh on ``torch.distributed`` (``core/meshes.py``,
``parallel/``, K5 beside K2 in ``csrc/qk_producers.cu``).

Module paths mirror ``frameino_tpu``; this package never imports jax.

Layout:
    core/        shape buckets, the dp x tp process mesh
    ops/         norms, dense and int8 dense, embeddings, rope, conv,
                 attention kernels, the int8 row quantizer, the CUDA build
    csrc/        CUDA C++ sources, built into build/ at first use
    models/      wan_dit, wan_vae, weights (bridge from the JAX trees),
                 quant (int8 DiT layers)
    schedulers/  flow_match_euler
    pipelines/   wan_i2v
    app/         HTTP server
    parallel/    process start-up and checks, tensor-parallel sharding
"""

__version__ = "0.1.0"
