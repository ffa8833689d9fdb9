"""The port's adafactor and prodigy against optax on the CPU: five updates
of ``make_optimizer``'s chain (global-norm clip, the rule; with warmup,
nonfinite skipping or accumulation around it) over a matrix large enough
to be factored, a small matrix and a vector; and a resume from
``state_dict`` mid-run.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from frameino_tpu.training import optim as joptim
from frameino_tpu_torch.training import optim as toptim


def _params():
    rs = np.random.RandomState(0)
    # w: 128 x 160 (two dims >= 128: row and column statistics), s: 4 x 3
    # and b: full second moments
    return {"w": (0.05 * rs.randn(128, 160)).astype(np.float32),
            "s": rs.randn(4, 3).astype(np.float32),
            "b": rs.randn(7).astype(np.float32)}


def _grads(n, scale, seed=1):
    rs = np.random.RandomState(seed)
    return [{k: (scale * rs.randn(*v.shape)).astype(np.float32)
             for k, v in _params().items()} for _ in range(n)]


def _run(ocfg, grad_seq, resume_at=None):
    """optax's trajectory and the port's over the gradient sequence; with
    ``resume_at`` the port's optimizer is rebuilt from its state_dict
    after that many updates."""
    p0 = _params()
    opt = joptim.make_optimizer(joptim.OptimizerConfig(**ocfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    topt = toptim.make_optimizer(toptim.OptimizerConfig(**ocfg), tp)
    traj_j, traj_t = [], []
    for i, g in enumerate(grad_seq):
        if i == resume_at:
            sd = {k: ({n: t.clone() for n, t in v.items()}
                      if isinstance(v, dict) else v)
                  for k, v in topt.state_dict().items()}
            topt = toptim.make_optimizer(toptim.OptimizerConfig(**ocfg),
                                         {k: torch.zeros_like(v)
                                          for k, v in tp.items()})
            topt.load_state_dict(sd)
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        traj_j.append({k: np.asarray(v) for k, v in jp.items()})
        traj_t.append({k: v.numpy().copy() for k, v in tp.items()})
    return traj_j, traj_t


CASES = {
    # the clip active (gradients of norm ~ 400) and inactive
    "adafactor_clipped": (dict(optimizer="adafactor", learning_rate=1e-2,
                               lr_warmup_steps=2), 3.0),
    "adafactor_unclipped": (dict(optimizer="adafactor", learning_rate=1e-2,
                                 lr_scheduler="constant"), 1e-3),
    "adafactor_accumulate_2": (dict(optimizer="adafactor",
                                    learning_rate=1e-2,
                                    lr_scheduler="constant",
                                    gradient_accumulation_steps=2), 1e-3),
    "prodigy_clipped": (dict(optimizer="prodigy", learning_rate=1.0,
                             weight_decay=1e-2), 3.0),
    "prodigy_unclipped": (dict(optimizer="prodigy", learning_rate=1.0,
                               beta2=0.99, epsilon=1e-8), 1e-3),
    "prodigy_skip_nonfinite": (dict(optimizer="prodigy", learning_rate=0.5,
                                    skip_nonfinite_updates=True), 1e-3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_rule_matches_optax(name):
    ocfg, scale = CASES[name]
    grads = _grads(5, scale)
    if ocfg.get("skip_nonfinite_updates"):
        grads[2] = {k: np.full_like(v, np.nan) for k, v in grads[2].items()}
    traj_j, traj_t = _run(ocfg, grads)
    assert not np.array_equal(traj_t[-1]["w"], _params()["w"])
    for j, t in zip(traj_j, traj_t):
        for k in j:
            # fp32, the same operations in the same order (sums and means
            # in another): 1e-6
            np.testing.assert_allclose(t[k], j[k], atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("rule", ["adafactor", "prodigy"])
def test_state_dict_resumes_exactly(rule):
    """3 updates, a state_dict into a fresh optimizer, 2 more: bit-equal to
    5 uninterrupted updates."""
    ocfg = dict(optimizer=rule, learning_rate=1e-2 if rule == "adafactor"
                else 1.0, lr_scheduler="constant")
    grads = _grads(5, 1e-3)
    _, straight = _run(ocfg, grads)
    _, resumed = _run(ocfg, grads, resume_at=3)
    for k in straight[-1]:
        np.testing.assert_array_equal(resumed[-1][k], straight[-1][k])


def test_adafactor_keeps_factored_statistics():
    tp = {k: torch.from_numpy(v) for k, v in _params().items()}
    opt = toptim.make_optimizer(toptim.OptimizerConfig(optimizer="adafactor"),
                                tp)
    assert toptim.factored_dims((128, 160)) == (0, 1)
    assert opt.v_row["w"].shape == (128,) and opt.v_col["w"].shape == (160,)
    assert opt.v["w"].numel() == 0 and opt.v["s"].shape == (4, 3)
    assert opt.v_row["b"].numel() == 0
