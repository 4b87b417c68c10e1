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

``read_unet`` reads a checkpoint's UNet without a Trainer, and
``side_weights`` a side model's (the VAE's, the OCR's): from the port's
files or from the JAX package's orbax directories (``train.orbax``, read
without JAX), whose Flax trees ``models.convert`` maps onto the port's keys;
both give state dicts in the port's keys. ``restore`` resumes a JAX run:
where the directory holds the JAX Trainer's orbax steps and no step of the
port, it loads the newest one's parameters, EMA, Adam moments and step
(``restore_jax``); the port writes its own checkpoints into the same
directory from then on, and ``locate`` reads the port's steps first.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch

from ..models.convert import jax_higan_to_torch, jax_unet_to_torch, state_dict_to_torch
from ..parallel.mesh import param_spec
from ..parallel.tensor import gather_state_dict, shard, shard_state_dict
from .orbax import COMMIT_FILE, is_orbax, orbax_step_dir, orbax_steps, read_orbax
from .state import TrainState

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
EMA_FILE = "ema_unet.pt"


def checkpoint_steps(directory: str) -> list[int]:
    """The steps of ``directory``'s complete checkpoints, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, STATE_FILE)))


def _neither(path: str, port: str) -> str:
    return (f"{path}: no {port}, and no orbax checkpoint (the JAX package's, "
            f"<step>/{COMMIT_FILE})")


def locate(ckpt_dir: str, step: Optional[int] = None) -> tuple[bool, int, str]:
    """Which checkpoint of ``ckpt_dir`` every reader reads (``read_unet``,
    ``CheckpointManager.restore``): -> (from JAX, its step, its path: the
    port's ``<step>/state.pt`` or the orbax step directory). ``ckpt_dir`` is
    a checkpoint directory, or one orbax step of one. The newest step, or
    ``step``, of the port's steps first, else of the JAX Trainer's orbax
    steps: a directory where the port resumed a JAX run holds both, and the
    port's steps continue the run. ``FileNotFoundError`` (its message
    starting with ``ckpt_dir``, so a CLI prefixes its flag) names both
    layouts where there is no such step."""
    if os.path.isfile(os.path.join(ckpt_dir, COMMIT_FILE)):  # one orbax step
        return True, int(os.path.basename(os.path.normpath(ckpt_dir))), ckpt_dir
    port, jax = checkpoint_steps(ckpt_dir), orbax_steps(ckpt_dir)
    for from_jax, steps in ((False, port), (True, jax)):
        if steps and (step is None or step in steps):
            found = steps[-1] if step is None else step
            path = os.path.join(ckpt_dir, str(found))
            return from_jax, found, path if from_jax else os.path.join(path, STATE_FILE)
    raise FileNotFoundError(_neither(ckpt_dir, f"checkpoint of the port"
                                     f"{'' if step is None else f' of step {step}'} "
                                     f"(<step>/{STATE_FILE})"))


def side_weights(pt: str, ckpt_dir: str, flag: str, name: str,
                 from_jax: Callable) -> Optional[dict]:
    """A side model's state dict in the port's keys, or None: ``pt``
    (``--vae_pt`` / ``--ocr_pt``), or what ``ckpt_dir`` (``--vae_ckpt`` /
    ``--ocr_ckpt``) holds: the JAX CLI's orbax directory (``cli.train_vae`` /
    ``cli.train_ocr``'s ``<save_dir>/ckpt``), whose newest step ``from_jax``
    maps onto the port's keys, or the port trainer's ``--save_dir`` (or its
    ``ckpt/``: ``side_file``) with ``name`` (``vae.pt`` / ``ocr.pt``). Both
    flags given, or a directory with neither layout, exit naming ``flag``."""
    if ckpt_dir and pt:
        raise SystemExit(f"{flag} and --{name.replace('.', '_')} both name the weights: "
                         f"pass one")
    if ckpt_dir and is_orbax(ckpt_dir):
        t0 = time.perf_counter()
        step_dir = orbax_step_dir(ckpt_dir)
        sd = state_dict_to_torch(from_jax(read_orbax(step_dir)))
        log.info("%s %s: orbax step %s read in %.2f s", flag, ckpt_dir,
                 os.path.basename(step_dir), time.perf_counter() - t0)
        return sd
    if ckpt_dir:
        pt = side_file(ckpt_dir, name)
        if pt is None:
            raise SystemExit(f"{flag} " + _neither(ckpt_dir, f"{name} in it (the file the "
                                                            f"port's trainer writes into its "
                                                            f"--save_dir)"))
    return torch.load(pt, map_location="cpu", weights_only=True) if pt else None


def side_file(ckpt_dir: str, name: str) -> Optional[str]:
    """The port trainer's ``name`` that ``ckpt_dir`` names, or None: the file
    in ``ckpt_dir``, or where ``ckpt_dir`` is ``<save_dir>/ckpt`` (the
    directory where the JAX trainers keep their weights, the path a JAX
    command line gives ``--vae_ckpt`` / ``--ocr_ckpt``), the file that the
    port's trainer writes into that ``<save_dir>``."""
    inner = os.path.join(ckpt_dir, name)
    if os.path.isfile(inner):
        return inner
    save_dir, last = os.path.split(os.path.normpath(ckpt_dir))
    beside = os.path.join(save_dir, name)
    return beside if last == "ckpt" and os.path.isfile(beside) else None


def unet_from_jax(tree, cfg, higan: bool = False) -> dict:
    """A Flax denoiser tree -> the port's keys, fp32 numpy: the UNet's
    (``jax_unet_to_torch``), or with ``higan`` the HiGAN+ adapter's."""
    return jax_higan_to_torch(tree) if higan else jax_unet_to_torch(tree, cfg)


def read_unet(ckpt_dir: str, use_ema: bool = True, step: Optional[int] = None, cfg=None,
              higan: bool = False) -> dict:
    """The UNet state dict in the port's keys (the one-process keys and
    shapes, whatever mesh trained it) of the checkpoint ``locate`` finds:
    its EMA weights, or with ``use_ema`` False the trained ones. From a JAX
    orbax step only ``ema_params`` or ``params`` is read, and mapped for
    ``cfg``, or with ``higan`` as the HiGAN+ denoiser. ``FileNotFoundError``
    as ``locate``'s."""
    from_jax, found, path = locate(ckpt_dir, step)
    if not from_jax:
        ck = torch.load(path, map_location="cpu", weights_only=True)
        return ck["ema" if use_ema else "model"]
    t0 = time.perf_counter()
    tree = read_orbax(path, "ema_params" if use_ema else "params")
    sd = state_dict_to_torch(unet_from_jax(tree, cfg, higan))
    log.info("%s: orbax step %d (%s) read in %.2f s", ckpt_dir, found,
             "ema_params" if use_ema else "params", time.perf_counter() - t0)
    return sd


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
        """The step ``restore`` reads (``locate``), or None."""
        try:
            return locate(self.directory)[1]
        except FileNotFoundError:
            return None

    def restore(self, state: TrainState, step: Optional[int] = None, mesh=None) -> TrainState:
        """Loads the checkpoint ``locate`` finds into ``state`` in place and
        returns it; under a model axis above 1 (``mesh``), this rank's shard
        of it. A JAX Trainer's orbax step resumes the JAX run
        (``restore_jax``)."""
        from_jax, _, path = locate(self.directory, step)
        if from_jax:
            return restore_jax(state, path, mesh)
        ck = torch.load(path, map_location="cpu", weights_only=True)
        return _load(state, ck["model"], ck["ema"], ck["optimizer"], int(ck["step"]), mesh)


def _load(state: TrainState, model: dict, ema: dict, opt: dict, step: int, mesh) -> TrainState:
    """The full (one-process) state dicts into ``state``, cut for this rank
    under a model axis above 1."""
    if mesh is not None and mesh.model > 1:
        model, ema = shard_state_dict(model, mesh), shard_state_dict(ema, mesh)
        opt = _optimizer_shards(opt, _names(state), mesh)
    state.model.load_state_dict(model)
    state.ema.load_state_dict(ema)
    state.optimizer.load_state_dict(opt)
    state.step = step
    return state


def restore_jax(state: TrainState, step_dir: str, mesh=None) -> TrainState:
    """The JAX Trainer's orbax ``TrainState`` {step, params, opt_state,
    ema_params} at ``step_dir`` into ``state``: the parameters and the EMA
    through ``jax_unet_to_torch`` (the HiGAN+ adapter's through
    ``jax_higan_to_torch``), optax's ``ScaleByAdamState`` (the first entry
    of ``optax.adamw``'s chain) ``mu``, ``nu`` and ``count`` as AdamW's
    ``exp_avg``, ``exp_avg_sq`` and ``step`` (the same moments: both update
    them as ``b1 * m + (1 - b1) * g`` and ``b2 * v + (1 - b2) * g^2`` and
    correct their bias by the count of updates); the learning rate and decay
    stay the port's."""
    from ..models.unet import UNet

    t0 = time.perf_counter()
    tree = read_orbax(step_dir)
    higan = not isinstance(state.model, UNet)
    cfg = state.model.cfg

    def port(t):
        return state_dict_to_torch(unet_from_jax(t, cfg, higan))

    adam = tree["opt_state"][0]
    if not {"count", "mu", "nu"} <= set(adam):
        raise ValueError(f"{step_dir}: opt_state[0] is not optax's ScaleByAdamState "
                         f"({sorted(adam)})")
    model, ema, mu, nu = (port(t) for t in (tree["params"], tree["ema_params"], adam["mu"],
                                            adam["nu"]))
    count = torch.tensor(float(int(adam["count"])))
    names = _names(state)
    opt = state.optimizer.state_dict()
    opt = {**opt, "state": {i: {"step": count.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                            for i, n in enumerate(names)}}
    step = int(tree["step"])
    log.info("resumed the JAX run at %s: step %d, Adam count %d (read in %.2f s)", step_dir,
             step, int(adam["count"]), time.perf_counter() - t0)
    return _load(state, model, ema, opt, step, mesh)


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
