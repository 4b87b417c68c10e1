"""Export a training checkpoint, the port's or the JAX package's, to a
reference-layout PyTorch state dict, so that the reference's own
``UNetModel`` (or ``UNetModelPhosc`` with ``--preset iam_phosc``) and its
tooling load it (the counterpart of ``worddiffusion_tpu/cli/export_torch.py``;
the inverse of ``cli.sample --torch_ckpt``).

    python -m worddiffusion_tpu_torch.cli.export_reference \\
        --preset iam --ckpt_dir runs/demo/ckpt --out ema_export.pt

``--ckpt_dir`` is the train CLI's checkpoint directory
(``<save_path>/ckpt``), the port's or the JAX package's orbax one (read
without JAX, ``train.orbax``): its newest step, or ``--step``, its EMA
weights or, with ``--use_ema 0``, the trained ones.
Under a model axis the checkpoint was gathered before it was written, so
the export needs no mesh. ``--template`` (an original reference
checkpoint) fills the keys this exporter does not write (dead tensors,
buffers, a CTC head) for a ``strict=True`` load; ``--middle_block1 1``
writes the ``--attentionMaps`` key layout (reference ``unet.py:1336-1366``).
The conversion is ``models.convert.port_unet_to_reference`` (of
``jax_unet_to_torch`` for an orbax directory).
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="port checkpoint -> reference torch state dict")
    p.add_argument("--preset", default="iam")
    p.add_argument("--ckpt_dir", required=True,
                   help="the train CLI's checkpoint directory (<save_path>/ckpt), the "
                        "port's or the JAX package's (orbax)")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--use_ema", type=int, default=1,
                   help="export the EMA weights (the reference samples from ema_*)")
    p.add_argument("--step", type=int, default=-1, help="the step to export; -1: the newest")
    p.add_argument("--template", default="",
                   help="reference torch ckpt whose extra keys (dead params, buffers) fill "
                        "the export for strict loads")
    p.add_argument("--middle_block1", type=int, default=0,
                   help="emit the --attentionMaps middle_block1 key layout (reference "
                        "unet.py:1336-1366)")
    return p


def main(argv=None) -> dict:
    """-> the exported state dict (also written to ``--out``)."""
    import torch

    from ..configs import presets
    from ..models.convert import load_torch_checkpoint, port_unet_to_reference
    from ..train.checkpoint import locate, read_unet

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    step = None if args.step < 0 else args.step
    cfg = presets.get(args.preset).unet
    try:
        step = locate(args.ckpt_dir, step)[1]
        sd = read_unet(args.ckpt_dir, bool(args.use_ema), step, cfg=cfg)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"--ckpt_dir {e}") from e
    template = load_torch_checkpoint(args.template) if args.template else None
    out = port_unet_to_reference(sd, cfg, template=template,
                                 middle_block1=bool(args.middle_block1))
    torch.save(out, args.out)
    logging.info("wrote %s: %d tensors (%s weights, step %d)", args.out, len(out),
                 "EMA" if args.use_ema else "trained", step)
    return out


if __name__ == "__main__":
    main()
