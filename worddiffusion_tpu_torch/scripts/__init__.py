"""The JAX repo's measurement scripts that describe the program, as the
port's own: ``profile_denoiser`` (the flagship denoiser call's device time
by layer bucket) and ``roofline_dump`` (that call's and the train step's
work and bound). Run each with ``python -m``."""
