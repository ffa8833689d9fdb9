"""The port's scripts, run as ``python -m frameino_tpu_torch.scripts.<name>``
(the attention experiments and their tuning scripts, the prompt cache, the
convergence run, the int8 certification), and what they share: the device
switch and the timer."""

from __future__ import annotations

import time

import torch

WARMUP = 1   # untimed launches before the timed ones (the first builds)


def pick_device(name: str) -> torch.device:
    """``cuda`` (the default of both scripts) needs a card and raises
    without one; ``cpu`` runs the kernels' plain versions."""
    if name == "cpu":
        return torch.device("cpu")
    if name != "cuda":
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("this script runs on a CUDA device and none is "
                           "available; --device cpu runs the plain "
                           "versions")
    return torch.device("cuda")


def timed(fn, iters: int, device: torch.device):
    """(seconds per call over ``iters`` calls after ``WARMUP`` untimed
    ones, seconds of the first call). CUDA events on the card; the host's
    clock on the CPU, where a time says nothing about the card."""
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, first_s
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters, first_s


def clock_tag(device: torch.device) -> str:
    """Appended to every printed time that is not the card's."""
    return "" if device.type == "cuda" else "  [cpu, host clock]"
