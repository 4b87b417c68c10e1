"""The port's reduce-on-plateau scale (``train/plateau.py``) against
``optax.contrib.reduce_on_plateau`` step for step, over a few hundred
seeded values: improvements (relative and absolute tolerances), plateaus,
cooldowns and repeated reductions. The scale sequences must be equal,
value for value (both in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from worddiffusion_tpu_torch.train.plateau import ReduceOnPlateau


def _values(n: int, seed: int) -> np.ndarray:
    """Improving stretches, flat stretches (within and just past the
    tolerances) and noise, as a negated validation accuracy gives them."""
    rng = np.random.default_rng(seed)
    out, v = [], 1e9
    for i in range(n):
        phase = (i // 25) % 4
        if phase == 0:
            v = -0.01 * (i % 25) - 0.3 * (i // 100)
        elif phase == 1:
            v = v + float(rng.choice([0.0, -2e-5, 5e-5]))
        elif phase == 2:
            v = v - float(rng.uniform(-0.02, 0.02))
        out.append(v)
    return np.asarray([1e9] * 3 + out)


@pytest.mark.parametrize("kw", [
    dict(factor=0.25, patience=5, cooldown=2, atol=1e-4),     # the CLI's, 1 step an epoch
    dict(factor=0.25, patience=20, cooldown=8, atol=1e-4),    # the CLI's, 4 steps an epoch
    dict(factor=0.5, patience=3, cooldown=0, rtol=1e-2),
    dict(factor=0.1, patience=2, cooldown=1, rtol=0.0, atol=1e-3),
])
def test_scale_sequence_matches_optax(kw):
    values = _values(400, seed=len(kw))
    tx = optax.contrib.reduce_on_plateau(**kw)
    params = {"w": jnp.zeros(1)}
    state = tx.init(params)
    update = jax.jit(lambda s, v: tx.update(params, s, value=v))
    want = []
    for v in values:
        _, state = update(state, jnp.asarray(v, jnp.float32))
        want.append(float(state.scale))
    plateau = ReduceOnPlateau(**kw)
    got = [plateau.update(float(v)) for v in values]
    assert got == want
    assert len(set(want)) > 3  # several reductions


def test_apply_sets_every_group_lr():
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW([{"params": [model.weight]}, {"params": [model.bias]}], lr=1.0)
    plateau = ReduceOnPlateau(factor=0.25, patience=1, cooldown=0, atol=1e-4)
    assert plateau.apply(opt, 1e-4, 1.0) == 1.0
    assert plateau.apply(opt, 1e-4, 1.0) == 0.25
    assert [g["lr"] for g in opt.param_groups] == [0.25e-4, 0.25e-4]


@pytest.mark.parametrize("kw,match", [(dict(factor=1.0), "Factor"), (dict(atol=-1.0), "non-neg"),
                                      (dict(rtol=0.0, atol=0.0), "At least one"),
                                      (dict(rtol=2.0), "rtol")])
def test_refuses_what_optax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        optax.contrib.reduce_on_plateau(**kw)
    with pytest.raises(ValueError, match=match):
        ReduceOnPlateau(**kw)
