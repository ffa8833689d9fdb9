"""Released-checkpoint parity harness on the port's loaders (counterpart of
``scripts/verify_checkpoint.py``: its ``compare`` and ``selftest`` modes).

    python -m frameino_tpu_torch.scripts.verify_checkpoint compare \\
        --model {umt5,wan_vae,cog_vae,wan_dit,cog_dit,scheduler} \\
        --checkpoint DIR --golden NPZ [--device cuda|cpu] \\
        [--dit_dtype bf16|fp32]
    python -m frameino_tpu_torch.scripts.verify_checkpoint selftest \\
        --tmpdir DIR [--device cuda|cpu]

``compare`` loads a checkpoint directory with
``models/pretrained.from_pretrained`` and replays the inputs of a golden
``.npz`` in the layout the JAX script's ``dump`` writes (diffusers on a
released checkpoint: seeded inputs and the golden activations, the DiTs'
first, middle and last block outputs among them), so one dump serves both
packages. A golden may also hold ``image`` [B, 257, image_dim], which a
Wan2.1 I2V DiT takes as its CLIP states (the JAX dump writes none). Each
tensor prints one ``_report`` line, the JAX script's; the exit code is 0
when every verdict passes, 1 otherwise.

Precision. On the CPU (``--device cpu``) everything runs in fp32, as the
JAX script pins its CPU backend to fp32 matmuls, under JAX's tolerances
(``TOL``). On the card (the default; it raises without one) the text
encoder, the VAEs and the scheduler run in fp32 with TF32 off under the
same tolerances; the DiTs run in bf16 through the attention kernels
(K1-K4 take bf16 only), where JAX's elementwise line is printed and the
verdict is each tensor's relative L2 error against ``DIT_BF16_REL_L2``.
``--dit_dtype bf16`` on the CPU gives the same reading through the plain
versions.

``selftest`` runs the contract with no released weights: a tiny UMT5
written and dumped through the installed ``transformers`` (a copy of the
JAX script's ``dump_umt5``; it raises, naming the package, where
transformers is missing) and compared; Wan2.2, Wan2.1 I2V and CogVideoX
tiny DiTs written by ``pretrained.save_pretrained`` and read back by
``from_pretrained``, every tensor bit-equal; the FlowMatch-Euler tables
against an inline golden of diffusers' ``set_timesteps``. The JAX
script's ``dump`` mode needs diffusers and is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

from frameino_tpu_torch.models import pretrained
from frameino_tpu_torch.scripts import pick_device

TOL = {
    "umt5": dict(atol=2e-4, rtol=1e-3),
    "wan_vae": dict(atol=5e-4, rtol=1e-3),
    "cog_vae": dict(atol=5e-4, rtol=1e-3),
    "wan_dit": dict(atol=2e-3, rtol=1e-2),
    "cog_dit": dict(atol=2e-3, rtol=1e-2),
    "scheduler": dict(atol=1e-6, rtol=0),
}
# Relative L2 limit of a bf16 DiT (the card's path) against an fp32
# golden: 1.5x the port's own CPU reading of bf16 against fp32 on the
# same checkpoints (2-block full-width Wan2.2-TI2V-5B and Wan2.1-I2V-14B
# at the dump's inputs, seeded random weights with N(0, 1) AdaLN tables;
# its largest tensor reading, 5.81e-3, the Wan2.2 middle block), set
# before the card's run on them.
DIT_BF16_REL_L2 = 8.7e-3
BLOCK_TAPS = ("block_first", "block_mid", "block_last")


def _seeded(shape, seed, scale=1.0):
    return (np.random.RandomState(seed)
            .standard_normal(shape).astype(np.float32) * scale)


def _pin_f32():
    """fp32 products everywhere: no TF32 in the card's matmuls and
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# Goldens in the dump layout
# ---------------------------------------------------------------------------

def dump_umt5(ckpt: str, out: dict, seed: int):
    """Live transformers: golden final hidden states for fixed token ids
    (the JAX script's ``dump_umt5``)."""
    try:
        from transformers import UMT5EncoderModel
    except ImportError as e:
        raise RuntimeError("selftest's UMT5 golden needs the transformers "
                           "package, which is not installed") from e
    model = UMT5EncoderModel.from_pretrained(
        ckpt, torch_dtype=torch.float32).eval()
    vocab = model.config.vocab_size
    ids = np.random.RandomState(seed).randint(2, vocab, (2, 16))
    attn = np.ones_like(ids)
    attn[1, 10:] = 0
    with torch.no_grad():
        h = model(input_ids=torch.tensor(ids),
                  attention_mask=torch.tensor(attn)).last_hidden_state
    out["input_ids"] = ids
    out["attention_mask"] = attn
    out["hidden_states"] = h.numpy()


def wan_dit_inputs(cfg, seed: int, with_image: bool = False) -> dict:
    """The Wan DiT dump's inputs: latents [1, C, 4, 16, 16], 32 text
    tokens, t = 500; ``with_image``: CLIP states [1, 257, image_dim]."""
    g = {"latents": _seeded((1, cfg.in_channels, 4, 16, 16), seed),
         "text": _seeded((1, 32, cfg.text_dim), seed + 1),
         "timestep": np.array([500.0], np.float32)}
    if with_image:
        g["image"] = _seeded((1, 257, cfg.image_dim), seed + 2)
    return g


def golden_wan_dit(model, seed: int = 0, with_image: bool = False) -> dict:
    """A golden in the dump layout from a port ``WanDiT`` (fp32 on the CPU
    for a reference): the output and the first, middle and last blocks'
    outputs."""
    g = wan_dit_inputs(model.cfg, seed, with_image)
    out, taps = _run_wan_dit(model, g, model.proj_out.weight.device)
    return dict(g, output=out, num_blocks=np.array(len(model.blocks)),
                **taps)


def golden_wan_vae(vae, seed: int = 0) -> dict:
    """The Wan VAE dump's inputs (9 frames of 64 x 64, crossing the chunk
    bound; latents of 3 frames of 8 x 8) and a port ``WanVAE``'s
    posterior mode and clamped decode."""
    dev = vae.quant_conv.weight.device
    g = {"pixels": _seeded((1, 3, 9, 64, 64), seed, 0.5),
         "latents": _seeded((1, vae.cfg.z_dim, 3, 8, 8), seed + 1)}
    enc, dec = _run_wan_vae(vae, g, dev)
    return dict(g, enc_mode=enc, decoded=dec)


def golden_umt5(model, seed: int = 0) -> dict:
    """The UMT5 dump's inputs (2 x 16 ids, the second row masked from 10)
    and a port ``T5Encoder``'s final hidden states."""
    ids = np.random.RandomState(seed).randint(2, model.cfg.vocab_size,
                                              (2, 16))
    attn = np.ones_like(ids)
    attn[1, 10:] = 0
    g = {"input_ids": ids, "attention_mask": attn}
    g["hidden_states"] = _run_umt5(model, g, model.shared.weight.device)
    return g


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

def _report(name, got, want, atol, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return [f"FAIL {name}: shape {got.shape} vs {want.shape}"], False
    err = np.abs(got - want)
    rel = err / (np.abs(want) + 1e-8)
    ok = bool((err <= atol + rtol * np.abs(want)).all())
    return [f"{'PASS' if ok else 'FAIL'} {name}: max_abs={err.max():.3e} "
            f"max_rel={rel.max():.3e} (atol={atol} rtol={rtol})"], ok


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _dit_report(name, got, want, tol, bf16: bool):
    """fp32: JAX's elementwise verdict. bf16: that line printed for the
    record, and the verdict on the relative L2 error."""
    lines, ok = _report(name, got, want, **tol)
    if not bf16:
        return lines, ok
    lines[0] = lines[0].replace("PASS ", "(elementwise) ", 1).replace(
        "FAIL ", "(elementwise) ", 1)
    if np.shape(got) != np.shape(want):
        return lines + [f"FAIL {name}: shape {np.shape(got)} vs "
                        f"{np.shape(want)}"], False
    r = rel_l2(got, want)
    ok = DIT_BF16_REL_L2 is not None and bool(r <= DIT_BF16_REL_L2)
    return lines + [f"{'PASS' if ok else 'FAIL'} {name}: rel_l2={r:.3e} "
                    f"(limit={DIT_BF16_REL_L2}, bf16)"], ok


def _t(a, device, dtype=None):
    t = torch.as_tensor(np.asarray(a), device=device)
    return t.to(dtype) if dtype is not None else t


def _run_umt5(model, g, device):
    from frameino_tpu_torch.models.t5_encoder import t5_encode
    h = t5_encode(model, _t(g["input_ids"], device),
                  _t(g["attention_mask"], device))
    return h.float().cpu().numpy()


def _tap_blocks(blocks, taps, slice_from: int = 0):
    """Forward hooks writing the first, middle and last block outputs (from
    token ``slice_from`` on) into ``taps``; returns their handles."""
    n = len(blocks)
    hooks = []
    for name, i in zip(BLOCK_TAPS, (0, n // 2, n - 1)):
        def hook(mod, inp, out, key=name):
            o = out[0] if isinstance(out, tuple) else out
            taps[key] = o[:, slice_from:].float().cpu().numpy()
        hooks.append(blocks[i].register_forward_hook(hook))
    return hooks


def _run_wan_dit(model, g, device):
    taps: Dict[str, np.ndarray] = {}
    hooks = _tap_blocks(model.blocks, taps)
    try:
        y = model(_t(g["latents"], device), _t(g["timestep"], device),
                  _t(g["text"], device),
                  _t(g["image"], device) if "image" in g else None)
    finally:
        for h in hooks:
            h.remove()
    return y.float().cpu().numpy(), taps


def _run_cog_dit(model, g, device):
    from frameino_tpu_torch.models.cogvideox_dit import cogvideox_rope
    lat = _t(g["latents"], device)
    F, H, W = lat.shape[1], lat.shape[3], lat.shape[4]
    taps: Dict[str, np.ndarray] = {}
    # a block's output is the joint [text; video] sequence; the diffusers
    # block returns the video part first
    hooks = _tap_blocks(model.transformer_blocks, taps,
                        slice_from=np.shape(g["text"])[1])
    try:
        y = model(lat, _t(g["text"], device), _t(g["timestep"], device),
                  cogvideox_rope(model.cfg, F, H, W, device=device))
    finally:
        for h in hooks:
            h.remove()
    return y.float().cpu().numpy(), taps


def _run_wan_vae(vae, g, device):
    enc = vae.encode(_t(g["pixels"], device))
    dec = vae.decode(_t(g["latents"], device))
    return enc.cpu().numpy(), dec.cpu().numpy()


def _run_cog_vae(vae, g, device):
    enc = vae.encode(_t(g["pixels"], device), sample_mode="argmax")
    dec = vae.decode(_t(g["latents"], device))
    return enc.float().cpu().numpy(), dec.float().cpu().numpy()


def _load(ckpt, device, dtype, class_name=None):
    return pretrained.from_pretrained(ckpt, class_name, device=device,
                                      dtype=dtype)


def compare_umt5(ckpt: str, g, tol, device, dit_dtype=None):
    cj = pretrained.read_config_json(ckpt)
    _, model = _load(ckpt, device, torch.float32,
                     None if "_class_name" in cj else "UMT5EncoderModel")
    return _report("umt5.hidden_states", _run_umt5(model, g, device),
                   g["hidden_states"], **tol)


def _compare_dit(kind, run, ckpt, g, tol, device, dit_dtype):
    _, model = _load(ckpt, device, dit_dtype)
    bf16 = dit_dtype == torch.bfloat16
    y, taps = run(model, g, device)
    lines, ok = _dit_report(f"{kind}.output", y, g["output"], tol, bf16)
    for name in BLOCK_TAPS:
        if name in g:
            li, oki = _dit_report(f"{kind}.{name}", taps[name], g[name], tol,
                                  bf16)
            lines += li
            ok &= oki
    return lines, ok


def compare_wan_dit(ckpt: str, g, tol, device, dit_dtype=torch.float32):
    return _compare_dit("wan_dit", _run_wan_dit, ckpt, g, tol, device,
                        dit_dtype)


def compare_cog_dit(ckpt: str, g, tol, device, dit_dtype=torch.float32):
    return _compare_dit("cog_dit", _run_cog_dit, ckpt, g, tol, device,
                        dit_dtype)


def compare_wan_vae(ckpt: str, g, tol, device, dit_dtype=None):
    _, vae = _load(ckpt, device, torch.float32)
    enc, dec = _run_wan_vae(vae, g, device)
    l1, ok1 = _report("wan_vae.enc_mode", enc, g["enc_mode"], **tol)
    l2, ok2 = _report("wan_vae.decoded", dec, g["decoded"], **tol)
    return l1 + l2, ok1 and ok2


def compare_cog_vae(ckpt: str, g, tol, device, dit_dtype=None):
    _, vae = _load(ckpt, device, torch.float32)
    enc, dec = _run_cog_vae(vae, g, device)
    l1, ok1 = _report("cog_vae.enc_mode", enc, g["enc_mode"], **tol)
    l2, ok2 = _report("cog_vae.decoded", dec, g["decoded"], **tol)
    return l1 + l2, ok1 and ok2


def compare_scheduler(ckpt: str, g, tol, device=None, dit_dtype=None):
    with open(os.path.join(ckpt, "scheduler_config.json")) as f:
        scfg = json.load(f)
    n = len(np.atleast_1d(g["timesteps"]))
    if "FlowMatch" in str(g["class_name"]):
        from frameino_tpu_torch.schedulers.flow_match_euler import (
            FlowMatchEulerConfig, inference_sigmas)
        cfg = FlowMatchEulerConfig(
            num_train_timesteps=scfg.get("num_train_timesteps", 1000),
            shift=scfg.get("shift", 1.0))
        sig, ts = inference_sigmas(cfg, n)
        lines, ok = _report("scheduler.timesteps", ts, g["timesteps"], **tol)
        if "sigmas" in g:
            # both carry steps + 1 sigmas, the trailing 0 included
            l2, ok2 = _report("scheduler.sigmas", sig, g["sigmas"], **tol)
            lines += l2
            ok &= ok2
        return lines, ok
    from frameino_tpu_torch.schedulers.ddim import (DDIMConfig,
                                                    ddim_alphas_cumprod,
                                                    inference_timesteps)
    cfg = DDIMConfig(**{k: v for k, v in scfg.items()
                        if k in DDIMConfig.__dataclass_fields__})
    lines, ok = _report("scheduler.alphas_cumprod", ddim_alphas_cumprod(cfg),
                        g["alphas_cumprod"], **tol)
    l2, ok2 = _report("scheduler.timesteps", inference_timesteps(cfg, n),
                      g["timesteps"], **tol)
    return lines + l2, ok and ok2


COMPARERS = {"umt5": compare_umt5, "wan_dit": compare_wan_dit,
             "wan_vae": compare_wan_vae, "cog_dit": compare_cog_dit,
             "cog_vae": compare_cog_vae, "scheduler": compare_scheduler}


def compare(model: str, ckpt: str, golden: str, device: torch.device,
            dit_dtype: torch.dtype = None):
    """(report lines, ok) of one checkpoint against one golden file."""
    _pin_f32()
    if dit_dtype is None:
        dit_dtype = torch.bfloat16 if device.type == "cuda" \
            else torch.float32
    if dit_dtype == torch.float32 and device.type == "cuda" \
            and model.endswith("_dit"):
        raise ValueError("the card's DiT path is bf16 (the attention "
                         "kernels take bf16 only)")
    g = dict(np.load(golden, allow_pickle=False))
    return COMPARERS[model](ckpt, g, TOL[model], device, dit_dtype)


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def _flowmatch_golden(shift: float, n_train: int, n_steps: int) -> dict:
    """diffusers ``FlowMatchEulerDiscreteScheduler.set_timesteps`` (static
    shift): linspace over [sigma_max, sigma_min] * N, / N, shifted by
    s / (1 + (s - 1) x), a trailing 0 appended; stored in fp32 and widened
    to fp64 as the dump does."""
    base = np.linspace(1, n_train, n_train, dtype=np.float64)[::-1] / n_train
    t = np.linspace(base[0] * n_train, base[-1] * n_train, n_steps,
                    dtype=np.float64)
    sg = t / n_train
    sg = shift * sg / (1 + (shift - 1) * sg)
    return {"class_name": np.array("FlowMatchEulerDiscreteScheduler"),
            "timesteps": (sg * n_train).astype(np.float32).astype(np.float64),
            "sigmas": np.concatenate([sg, [0.0]]).astype(np.float32)
            .astype(np.float64)}


def _selftest_dits(tmpdir: str, device: torch.device):
    """Tiny DiTs written by ``save_pretrained`` and read back by
    ``from_pretrained``: [(name, tensors, bit-equal)]."""
    from frameino_tpu_torch.models import cogvideox_dit, wan_dit
    g = torch.Generator().manual_seed(0)
    models = {
        "wan_dit": wan_dit.init_wan_dit(wan_dit.tiny_config(), g),
        "wan21_i2v_dit": wan_dit.init_wan_dit(wan_dit.tiny_config(
            in_channels=12, out_channels=4, image_dim=8,
            added_kv_proj_dim=48), g),
        "cog_dit": cogvideox_dit.init_cogvideox_dit(
            cogvideox_dit.tiny_config(), g)}
    out = []
    for name, model in models.items():
        d = os.path.join(tmpdir, name)
        pretrained.save_pretrained(d, model.cfg, model)
        cfg, back = pretrained.from_pretrained(d, device=device)
        want, got = model.state_dict(), back.state_dict()
        same = cfg == model.cfg and set(want) == set(got) and all(
            torch.equal(want[k], got[k].cpu()) for k in want)
        out.append((name, len(want), same))
    return out


def selftest(tmpdir: str, device: torch.device) -> int:
    rc = 0
    _pin_f32()
    # (a) tiny UMT5: written and dumped by transformers, compared here
    try:
        from transformers import UMT5Config, UMT5EncoderModel
    except ImportError as e:
        raise RuntimeError("selftest's UMT5 part needs the transformers "
                           "package, which is not installed") from e
    ck = os.path.join(tmpdir, "umt5")
    torch.manual_seed(0)
    hf = UMT5EncoderModel(UMT5Config(
        vocab_size=128, d_model=16, d_kv=4, num_heads=2, d_ff=32,
        num_layers=2, feed_forward_proj="gated-gelu")).eval()
    hf.save_pretrained(ck, safe_serialization=True)
    g = {}
    dump_umt5(ck, g, seed=0)
    path = os.path.join(tmpdir, "umt5_golden.npz")
    np.savez(path, **g)
    lines, ok = compare("umt5", ck, path, device)
    print("\n".join(lines))
    rc |= 0 if ok else 1

    # (b) DiT export -> safetensors -> reload round trips
    for name, n, same in _selftest_dits(tmpdir, device):
        print(f"{'PASS' if same else 'FAIL'} {name}: safetensors "
              f"export->reload round-trip ({n} tensors)")
        rc |= 0 if same else 1

    # (c) the scheduler tables against an inline diffusers golden
    sck = os.path.join(tmpdir, "sched")
    os.makedirs(sck, exist_ok=True)
    shift, n_train, n_steps = 3.0, 1000, 10
    with open(os.path.join(sck, "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "FlowMatchEulerDiscreteScheduler",
                   "num_train_timesteps": n_train, "shift": shift}, f)
    path = os.path.join(tmpdir, "sched_golden.npz")
    np.savez(path, **_flowmatch_golden(shift, n_train, n_steps))
    lines, ok = compare("scheduler", sck, path, device)
    print("\n".join(lines))
    rc |= 0 if ok else 1
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("compare")
    c.add_argument("--model", required=True, choices=sorted(COMPARERS))
    c.add_argument("--checkpoint", required=True)
    c.add_argument("--golden", required=True)
    c.add_argument("--device", default="cuda")
    c.add_argument("--dit_dtype", choices=("bf16", "fp32"), default=None,
                   help="the DiTs' dtype (default: bf16 on the card, fp32 "
                        "on the CPU)")
    s = sub.add_parser("selftest")
    s.add_argument("--tmpdir", required=True)
    s.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = pick_device(args.device)
    if args.cmd == "compare":
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32,
                 None: None}[args.dit_dtype]
        lines, ok = compare(args.model, args.checkpoint, args.golden, device,
                            dtype)
        print("\n".join(lines))
        return 0 if ok else 1
    os.makedirs(args.tmpdir, exist_ok=True)
    return selftest(args.tmpdir, device)


if __name__ == "__main__":
    sys.exit(main())
