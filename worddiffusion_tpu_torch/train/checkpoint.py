"""Checkpoints of the full train state (port of
``worddiffusion_tpu/train/checkpoint.py``, which uses orbax).

Each checkpoint is a step-named directory ``<dir>/<step>/`` holding
``state.pt`` ({step, model, optimizer, ema, metrics}) and ``ema_unet.pt``,
the EMA weights alone as a reference-keyed UNet state dict: the
regeneration CLI's ``--torch_ckpt``. Both are written with
``torch.save`` into a temporary directory that ``os.replace`` then
moves into place, so a reader never sees half a checkpoint. The newest
``max_to_keep`` are kept.

Under a model axis above 1 (tensor parallel) the model, the EMA and the
optimizer's moments are gathered over the model group before the write, so
a checkpoint has the one-process run's keys and shapes whatever the mesh
(the regeneration and sampling CLIs read it unchanged), and ``restore``
cuts it for this rank: a run resumes bitwise at the same mesh and loads at
any other.

``read_unet`` reads a checkpoint's UNet without a Trainer: the directory the
JAX CLIs' ``--ckpt_dir`` names, here the port train CLI's. The JAX package's
own directories are orbax's, which the port recognises and refuses
(``is_orbax``): their OCDBT manifest and data files are zstd-compressed,
and neither Python's standard library nor anything the port depends on
decodes zstd.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

from ..parallel.mesh import param_spec
from ..parallel.tensor import gather_state_dict, shard, shard_state_dict
from .state import TrainState

STATE_FILE = "state.pt"
EMA_FILE = "ema_unet.pt"
# the files by which an orbax checkpoint directory is known
ORBAX_FILES = ("_CHECKPOINT_METADATA", "manifest.ocdbt")
ORBAX_REFUSAL = ("an orbax checkpoint (the JAX package's); its OCDBT manifest and data files "
                 "are zstd-compressed (frame magic 28 b5 2f fd), and neither Python's standard "
                 "library nor the port's dependencies decode zstd, so the port cannot read it. "
                 "The port's own trainers write what these flags read: cli.train's "
                 "<save_path>/ckpt, cli.train_vae's and cli.train_ocr's --save_dir")


def is_orbax(path: str, depth: int = 3) -> bool:
    """Whether ``path`` is (or holds, ``depth`` levels down) an orbax
    checkpoint, by its ``_CHECKPOINT_METADATA`` or ``manifest.ocdbt``."""
    if not os.path.isdir(path):
        return False
    names = os.listdir(path)
    if any(n in ORBAX_FILES for n in names):
        return True
    return depth > 0 and any(is_orbax(os.path.join(path, n), depth - 1) for n in names)


def refuse_orbax(flag: str, path: str) -> None:
    """Exit naming ``flag`` and the reason where ``path`` is an orbax
    checkpoint."""
    if path and is_orbax(path):
        raise SystemExit(f"{flag} {path} is {ORBAX_REFUSAL}")


def checkpoint_steps(directory: str) -> list[int]:
    """The steps of ``directory``'s complete checkpoints, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, STATE_FILE)))


def weights_file(pt: str, ckpt_dir: str, flag: str, name: str) -> str:
    """A side model's state dict: ``pt`` (``--vae_pt`` / ``--ocr_pt``), or
    ``name`` in ``ckpt_dir`` (``--vae_ckpt`` / ``--ocr_ckpt`` name the
    ``--save_dir`` that ``cli.train_vae`` / ``cli.train_ocr`` write ``vae.pt``
    / ``ocr.pt`` into). Both given, an orbax directory, or a directory without
    the file exit naming ``flag``."""
    if not ckpt_dir:
        return pt
    if pt:
        raise SystemExit(f"{flag} and --{name.replace('.', '_')} both name the weights: "
                         f"pass one")
    refuse_orbax(flag, ckpt_dir)
    path = os.path.join(ckpt_dir, name)
    if not os.path.isfile(path):
        raise SystemExit(f"{flag} {ckpt_dir}: no {name} in it (the file the port's trainer "
                         f"writes into its --save_dir)")
    return path


def read_unet(ckpt_dir: str, use_ema: bool = True, step: Optional[int] = None) -> dict:
    """The UNet state dict (the one-process keys and shapes, whatever mesh
    trained it) of ``ckpt_dir``'s newest checkpoint, or of ``step``: its EMA
    weights, or with ``use_ema`` False the trained ones. An orbax directory
    raises ``ValueError``, one without a checkpoint ``FileNotFoundError``;
    each message starts with ``ckpt_dir``, so a CLI prefixes its flag."""
    if is_orbax(ckpt_dir):
        raise ValueError(f"{ckpt_dir} is {ORBAX_REFUSAL}")
    steps = checkpoint_steps(ckpt_dir)
    if not steps or (step is not None and step not in steps):
        raise FileNotFoundError(f"{ckpt_dir} holds no checkpoint"
                                f"{'' if step is None else f' of step {step}'} "
                                f"(<step>/{STATE_FILE})")
    step = steps[-1] if step is None else step
    ck = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), map_location="cpu",
                    weights_only=True)
    return ck["ema" if use_ema else "model"]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return checkpoint_steps(self.directory)

    def path(self, step: int, name: str = STATE_FILE) -> str:
        return os.path.join(self.directory, str(step), name)

    def save(self, step: int, state: TrainState, metrics: Optional[dict] = None,
             mesh=None) -> None:
        """Write ``state``. Under a model axis above 1 (``mesh``) every rank
        of the model group calls it: the shards are gathered over the group
        and its model rank 0 writes."""
        full = gathered(state, mesh)
        if mesh is not None and mesh.model_rank != 0:
            return
        tmp = tempfile.mkdtemp(prefix=".tmp-", dir=self.directory)
        torch.save({
            "step": int(state.step), **full,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }, os.path.join(tmp, STATE_FILE))
        torch.save(full["ema"], os.path.join(tmp, EMA_FILE))
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None, mesh=None) -> TrainState:
        """Loads the checkpoint into ``state`` in place and returns it; under
        a model axis above 1 (``mesh``), this rank's shard of it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        ck = torch.load(self.path(step), map_location="cpu", weights_only=True)
        model, ema, opt = ck["model"], ck["ema"], ck["optimizer"]
        if mesh is not None and mesh.model > 1:
            model, ema = shard_state_dict(model, mesh), shard_state_dict(ema, mesh)
            opt = _optimizer_shards(opt, _names(state), mesh)
        state.model.load_state_dict(model)
        state.ema.load_state_dict(ema)
        state.optimizer.load_state_dict(opt)
        state.step = int(ck["step"])
        return state


def _names(state: TrainState) -> list[str]:
    """The optimizer's parameter indices' state-dict keys (it was made over
    ``state.model.parameters()``, in that order)."""
    return [n for n, _ in state.model.named_parameters()]


def _moment_spec(names: list[str]):
    """The layout of an optimizer state entry keyed ``(index, name)``: its
    parameter's, for a tensor of the parameter's shape."""
    return lambda key: param_spec(names[key[0]])


def _optimizer_shards(opt: dict, names: list[str], mesh) -> dict:
    """A full optimizer state dict cut for this model rank."""
    state = {i: {k: (shard(v, param_spec(names[i]), mesh.model, mesh.model_rank)
                     if v.dim() else v) for k, v in st.items()}
             for i, st in opt["state"].items()}
    return {**opt, "state": state}


def gathered(state: TrainState, mesh=None) -> dict:
    """{model, optimizer, ema}: the state dicts, full. Under a model axis
    above 1 a collective over the model group (its ranks each call it)."""
    model, ema = state.model.state_dict(), state.ema.state_dict()
    opt = state.optimizer.state_dict()
    if mesh is None or mesh.model == 1:
        return dict(model=model, optimizer=opt, ema=ema)
    names = _names(state)
    moments = {(i, k): v for i, st in opt["state"].items() for k, v in st.items() if v.dim()}
    moments = gather_state_dict(moments, mesh, _moment_spec(names))
    full_opt = {**opt, "state": {i: {k: moments.get((i, k), v) for k, v in st.items()}
                                 for i, st in opt["state"].items()}}
    return dict(model=gather_state_dict(model, mesh), optimizer=full_opt,
                ema=gather_state_dict(ema, mesh))
