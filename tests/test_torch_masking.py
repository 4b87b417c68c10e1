"""The port's latent masking (``diffusion/masking.py``) against the JAX
module: ``timestep_mask`` at every step of a 40-step schedule bit for bit
(the threshold and the dilation size in fp32 as JAX computes them, the 3x3
dilation as a -inf-padded max), and ``masked_ddpm_sample`` over a 12-step
schedule with a closed-form denoiser, JAX's ``fold_in(rng, i)`` draws
handed in, within 1e-5 of the largest value (fp32), snapshots included."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from worddiffusion_tpu.diffusion import masking as jmasking
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule as JNoiseSchedule
from worddiffusion_tpu_torch.diffusion import masking
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule


def _latents(seed=0, shape=(3, 8, 32, 4)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 1.5, shape).astype(np.float32)


def test_timestep_mask_matches_jax():
    ref = _latents()
    T = 40
    for t in range(T):
        want = np.asarray(jmasking.timestep_mask(jnp.asarray(ref), jnp.asarray(t), T))
        got = masking.timestep_mask(torch.from_numpy(ref), t, T).numpy()
        assert np.array_equal(got, want), t


def test_masked_ddpm_sample_matches_jax():
    T = 12
    ref = _latents(1)
    x0 = np.random.default_rng(2).standard_normal(ref.shape).astype(np.float32)
    rng = jax.random.PRNGKey(7)

    def jeps(x, t):
        return 0.1 * x + 0.01 * t[:, None, None, None].astype(jnp.float32)

    def eps(x, t):
        return 0.1 * x + 0.01 * t[:, None, None, None].float()

    want, want_snaps = jmasking.masked_ddpm_sample(JNoiseSchedule.linear(T), jeps, rng,
                                                   jnp.asarray(ref), jnp.asarray(x0),
                                                   snapshot_every=3)

    def noises(i):
        return torch.from_numpy(np.asarray(jax.random.normal(jax.random.fold_in(rng, i),
                                                             ref.shape, jnp.float32)))

    got, snaps = masking.masked_ddpm_sample(NoiseSchedule.linear(T), eps, torch.from_numpy(ref),
                                            x_init=torch.from_numpy(x0), noises=noises,
                                            snapshot_every=3)
    want, want_snaps = np.asarray(want), np.asarray(want_snaps)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert snaps.shape == want_snaps.shape
    assert np.abs(snaps.numpy() - want_snaps).max() <= 1e-5 * np.abs(want_snaps).max()
    # the generator path: seeded, repeatable, and no snapshots unless asked
    g = [masking.masked_ddpm_sample(NoiseSchedule.linear(T), eps, torch.from_numpy(ref),
                                    generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    assert torch.equal(g[0][0], g[1][0]) and g[0][1] is None
