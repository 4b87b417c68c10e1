"""The JAX repo's end-to-end chains (``scripts/*_chain.sh``,
``scripts/phosc_syn5_gzsl.sh``) as the port's own: one module a chain, each
with ``stages()``, run by ``run.py`` (``python -m
worddiffusion_tpu_torch.chains <chain>``)."""
