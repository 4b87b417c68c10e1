"""The runner of the port's end-to-end chains: the JAX repo's
``scripts/*_chain.sh`` (and ``scripts/phosc_syn5_gzsl.sh``), each an
ordered list of stages from an empty runs directory to trained weights, an
OCR-filtered corpus and its evaluation.

    python -m worddiffusion_tpu_torch.chains <chain> [--runs_dir runs/torch] \\
        [--device cuda] [--stages a,b] [--smoke]

A stage is one or more steps, each a port CLI's ``main(argv)`` (``Cli``,
with ``argv`` exactly as the JAX script writes it) or a Python function
ported from one of the script's ``python - <<'PYEOF'`` blocks (``Py``).
Every path the scripts write under ``runs/`` lands under ``--runs_dir``,
and ``--device`` is passed to every CLI. A stage is skipped where its
marker exists; the marker is written only after the stage returns, so an
interrupted stage runs again (a regeneration then resumes, skipping the
images already on disk). The markers are the scripts' own guards where
they have one (``<save_dir>/.done``; for the latent DDPM, its last
checkpoint in the port's layout, ``<save_path>/ckpt/<last step>/state.pt``)
and ``.chains/<chain>/<stage>.done`` under ``--runs_dir`` for the stages
the scripts run every time. ``--smoke`` cuts epochs and corpus sizes to
``SMOKE``; presets, widths and every other flag stay.

Each stage appends a line to ``.chains/<chain>/log.jsonl`` under
``--runs_dir``: its name, whether it was skipped, its wall seconds, the
card's peak allocated bytes during it and the launches of kernels B.1, B.3,
B.4, B.5 and B.6 it made.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import logging
import os
import time
from typing import Callable, Union

log = logging.getLogger(__name__)

CHAINS = ("iam", "gw", "cvl", "nor", "nor_special", "higan", "style", "phosc_gzsl")

# --smoke: the value each flag (or a Python step's keyword of that name) takes
SMOKE = {"--epochs": "1", "--vocab_size": "2", "--samples_per_word": "64", "--n_synth": "80",
         "--renders_per_word": "8"}

RUNS = "runs/"  # the scripts' artifact root, rebased under --runs_dir


@dataclasses.dataclass(frozen=True)
class Cli:
    """``worddiffusion_tpu_torch.cli.<module>.main(argv)``."""
    module: str
    argv: tuple


@dataclasses.dataclass(frozen=True)
class Py:
    """``fn(**kwargs)``: a ported ``python -`` block."""
    fn: Callable
    kwargs: dict


class Stage:
    """A chain's stage: its ``steps`` in order and its ``marker``, a path the
    runner writes once the steps return, a function of the resolved steps
    naming a file the steps write last, or None for ``done(<chain>,
    name)``, the marker of a stage the script runs every time."""

    def __init__(self, name: str, *steps, marker: Union[str, Callable, None] = None):
        self.name, self.steps, self.marker = name, steps, marker


def cli(module: str, args: str) -> Cli:
    """A CLI step from the script's text (one shell word per token)."""
    return Cli(module, tuple(args.split()))


def done(chain: str, stage: str) -> str:
    """The marker of a stage the script runs every time."""
    return f"{RUNS}.chains/{chain}/{stage}.done"


def _arg(argv, flag: str) -> str:
    return argv[argv.index(flag) + 1]


def train_checkpoint(steps) -> str:
    """The last checkpoint the stage's synthetic-corpus ``train`` run writes:
    ``<save_path>/ckpt/<epochs x (vocab_size x samples_per_word //
    batch_size)>/state.pt``."""
    argv = next(s.argv for s in steps if isinstance(s, Cli) and s.module == "train")
    n = int(_arg(argv, "--vocab_size")) * int(_arg(argv, "--samples_per_word"))
    last = int(_arg(argv, "--epochs")) * max(n // int(_arg(argv, "--batch_size")), 1)
    return os.path.join(_arg(argv, "--save_path"), "ckpt", str(last), "state.pt")


def rebase(value, runs_dir: str):
    """A script path under ``runs/`` -> the same path under ``runs_dir``."""
    if isinstance(value, str) and value.startswith(RUNS):
        return os.path.join(runs_dir, value[len(RUNS):])
    if isinstance(value, (tuple, list)):
        return type(value)(rebase(v, runs_dir) for v in value)
    return value


def resolve(step, runs_dir: str, smoke: bool = False, device: str | None = None):
    """The step as it runs: paths rebased, ``SMOKE`` applied, ``--device``
    appended to a CLI's argv."""
    if isinstance(step, Cli):
        argv = list(step.argv)
        if smoke:
            for i in range(len(argv) - 1):
                if argv[i] in SMOKE:
                    argv[i + 1] = SMOKE[argv[i]]
        argv = [rebase(a, runs_dir) for a in argv]
        if device is not None:
            argv += ["--device", device]
        return Cli(step.module, tuple(argv))
    kwargs = {}
    for k, v in step.kwargs.items():
        if smoke and f"--{k}" in SMOKE:
            v = type(v)(SMOKE[f"--{k}"])
        kwargs[k] = rebase(v, runs_dir)
    return Py(step.fn, kwargs)


def stages_of(chain: str) -> list[Stage]:
    """``chain``'s stages, unresolved (paths under ``runs/``)."""
    return importlib.import_module(f"{__package__}.{chain}").stages()


def launch_counts() -> dict:
    """The port's kernel launches so far: B.1, B.3, B.4, B.5, B.6."""
    from ..ops import attention, ffn, gn_conv, groupnorm

    return {"B.1": ffn.launches, "B.3": ffn.bwd_launches, "B.4": attention.launches,
            "B.5": groupnorm.launches, "B.6": gn_conv.launches}


def side_dir_present(path: str, name: str) -> bool:
    """Whether ``--vae_ckpt`` / ``--ocr_ckpt`` ``path`` names weights (see
    ``train.checkpoint.side_weights``)."""
    from ..train.checkpoint import side_file
    from ..train.orbax import is_orbax

    return (os.path.isdir(path) and is_orbax(path)) or side_file(path, name) is not None


def _run_step(step) -> None:
    if isinstance(step, Cli):
        log.info("chain: cli.%s %s", step.module, " ".join(step.argv))
        importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.cli.{step.module}").main(
            list(step.argv))
    else:
        log.info("chain: %s(%s)", step.fn.__name__,
                 ", ".join(f"{k}={v!r}" for k, v in step.kwargs.items()))
        step.fn(**step.kwargs)


def run_chain(chain: str, runs_dir: str = "runs/torch", device: str = "cuda",
              stages: tuple = (), smoke: bool = False) -> list[dict]:
    """Run ``chain``'s stages (only those named in ``stages``, if any) in
    order, skipping those whose marker exists. -> one record per stage (as
    ``log.jsonl``'s lines)."""
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    module = importlib.import_module(f"{__package__}.{chain}")
    for path, name in getattr(module, "REQUIRES", ()):
        where = rebase(path, runs_dir)
        if not side_dir_present(where, name):
            raise SystemExit(f"chain {chain}: {where} holds no weights (an orbax checkpoint or "
                             f"{name} beside it), and no stage of this chain makes it; "
                             f"see the chain's docstring")
    every = module.stages()
    unknown = set(stages) - {s.name for s in every}
    if unknown:
        raise SystemExit(f"chain {chain} has no stage {sorted(unknown)}; its stages: "
                         f"{[s.name for s in every]}")
    log_dir = os.path.join(runs_dir, ".chains", chain)
    os.makedirs(log_dir, exist_ok=True)
    on_card = device.startswith("cuda")
    records = []
    for st in every:
        if stages and st.name not in stages:
            continue
        steps = [resolve(s, runs_dir, smoke, device if isinstance(s, Cli) else None)
                 for s in st.steps]
        named = done(chain, st.name) if st.marker is None else st.marker
        marker = rebase(named, runs_dir) if isinstance(named, str) else named(steps)
        rec = {"chain": chain, "stage": st.name, "marker": marker, "smoke": smoke}
        if os.path.exists(marker):
            log.info("chain %s: stage %s done (%s), skipped", chain, st.name, marker)
            rec["skipped"] = True
        else:
            log.info("chain %s: stage %s", chain, st.name)
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before, t0 = launch_counts(), time.perf_counter()
            for step in steps:
                _run_step(step)
            if on_card:
                torch.cuda.synchronize()
            rec.update(skipped=False, seconds=time.perf_counter() - t0,
                       peak_bytes=torch.cuda.max_memory_allocated() if on_card else None,
                       launches={k: v - before[k] for k, v in launch_counts().items()})
            if isinstance(named, str):
                os.makedirs(os.path.dirname(marker), exist_ok=True)
                with open(marker, "w"):
                    pass
            elif not os.path.exists(marker):
                raise RuntimeError(f"chain {chain}: stage {st.name} returned without "
                                   f"writing {marker}")
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        with open(os.path.join(log_dir, "log.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
    return records


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m worddiffusion_tpu_torch.chains",
                                description="the port's end-to-end chains")
    p.add_argument("chain", choices=CHAINS)
    p.add_argument("--runs_dir", default="runs/torch",
                   help="where every artifact lands (the scripts' runs/)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; cpu must be asked for explicitly")
    p.add_argument("--stages", default="",
                   help="comma-separated stage names: run only these (markers still apply)")
    p.add_argument("--smoke", action="store_true",
                   help="cut epochs and corpus sizes to run.SMOKE (tests, chip_smoke.py)")
    return p


def main(argv=None) -> list[dict]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    return run_chain(args.chain, args.runs_dir, args.device,
                     tuple(s for s in args.stages.split(",") if s), args.smoke)
