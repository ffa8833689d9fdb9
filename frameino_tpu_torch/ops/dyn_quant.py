"""Dynamic per-row int8 quantization of activations, K7 (counterpart of
``frameino_tpu/ops/dyn_quant.py``).

``dynamic_quantize_rows(x)`` maps ``x [..., D]`` to ``(xq int8 [..., D],
s fp32 [..., 1])`` with

    s  = max(amax(|x|) * fp32(1/127), 1e-12)
    xq = round_half_even(x / s)

all in fp32. This is the function JAX's ``dense_int8`` computes under
``jit``: XLA rewrites the division of the absmax by the constant 127 into
a multiplication by its fp32 reciprocal, while ``x / s`` stays a true
division. A division by 127 here would move some scales by one ulp and
flip codes.

The JAX package ships its Pallas version disabled: XLA fuses the absmax
and the rounding into the producers on the TPU. PyTorch's eager plain
version is five passes over each activation (abs, amax, divide, round,
cast); the CUDA kernel (``csrc/dyn_quant.cu``) is one read and one int8
write. For a CUDA bf16 tensor the wrapper launches the kernel, for any
other CUDA tensor it raises, and for a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

import torch

from frameino_tpu_torch.ops.cuda_build import check_cuda_bf16, lib

# the fp32-rounded 1/127 that XLA multiplies by
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
SCALE_FLOOR = 1e-12


def dynamic_quantize_rows_ref(x):
    """Plain version of K7: (xq int8 [..., D], s fp32 [..., 1])."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True)
                        * INV_127.to(xf.device), SCALE_FLOOR)
    return torch.round(xf / s).to(torch.int8), s


def dynamic_quantize_rows(x):
    """K7 (replaces ``dynamic_quantize_rows`` / ``_dyn_quant_kernel``): one
    pass per row of ``x [..., D]``. CUDA: the kernel, for contiguous bf16
    only; CPU: ``dynamic_quantize_rows_ref``."""
    if not x.is_cuda:
        return dynamic_quantize_rows_ref(x)
    if x.ndim == 0 or x.shape[-1] == 0 or x.numel() == 0:
        raise ValueError(f"dynamic_quantize_rows: empty rows {tuple(x.shape)}")
    check_cuda_bf16("dynamic_quantize_rows", x)
    d = x.shape[-1]
    n = x.numel() // d
    if n >= 2 ** 31:
        raise ValueError(f"dynamic_quantize_rows: {n} rows exceed the grid")
    xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    err = lib("dyn_quant").dyn_quant_rows_bf16(
        x.data_ptr(), xq.data_ptr(), s.data_ptr(), n, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dyn_quant_rows_bf16 launch failed: CUDA error "
                           f"{err}")
    dynamic_quantize_rows.launches += 1
    return xq, s


dynamic_quantize_rows.launches = 0
