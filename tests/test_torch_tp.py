"""Tensor parallelism (``--mesh_model > 1``): ``parallel.mesh.param_spec``,
``parallel.tensor`` and the sharded UNet, block and Trainer.

The multi-process runs go through ``torchrun`` with gloo on the CPU, as a
user launches them: 2 ranks on a ``MeshConfig(data=1, model=2)`` grid and 4
on ``MeshConfig(data=2, model=2)``, one launch each. In them:

- a ``BasicTransformerBlock`` at 32 channels and 4 heads, sharded over 2
  ranks, against the unsharded port block (and, in this process, the JAX
  block) on the same weights: the output and every gradient, for the
  cross-attention layout, PHOSC's self-attention layout and the fold;
- two train steps on JAX's batches and draws against the one-process port
  steps and JAX's jitted step on the same mesh over this suite's 8 CPU
  devices (JAX places the parameters by ``param_sharding``);
- every replicated parameter, the EMA's and each block's outputs bitwise
  equal across the model ranks;
- the Trainer's run (its own draws), a max_steps stop and a resume bitwise
  the uninterrupted run, its gathered checkpoint loaded in one process;
- the train CLI with ``--mesh_model 2`` (and ``--mesh_data 2``), against
  the one-process CLI run;
- at 1x2, the two steps again with ``remat=True``: every parameter bitwise
  the steps' without it, the recompute's forward all-reduces counted;
- at 1x2, a JAX run resumed under the model axis (the JAX Trainer's orbax
  steps, ``tests/test_torch_orbax.py::write_jax_run``): ``restore_jax``
  gives each rank exactly ``shard_state_dict`` of the one-process restore
  (model, EMA, both AdamW moments, the count), and the Trainer's next step
  matches the one-process resumed step within ``chip_smoke.tp_param_check``'s
  bounds (each tensor's difference within a tenth of its movement, 99% of
  the entries within 1e-5).

Tolerances (fp32): the model ranks' partial sums are added in another order
than one process's matmul, so outputs and gradients differ by rounding: a
block's by 1e-5 of the largest entry against the unsharded port block, 1e-4
against JAX (as ``test_torch_train``). After Adam's steps the parameters
are held as in ``test_torch_ddp``: Adam's first updates are about
``lr * sign(g)``, so a gradient that is rounding noise on both sides can move
its parameter by up to ``2 * lr`` a step however close the gradients are;
lr is 1e-5, so two steps bound every difference by 4e-5, and 99% of the
entries are held to 1e-7 besides.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs.config import MeshConfig as JaxMesh
from worddiffusion_tpu.diffusion import forward as jforward
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models import convert as jconvert
from worddiffusion_tpu.models.attention import BasicTransformerBlock as JaxBlock
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh
from worddiffusion_tpu.parallel.mesh import param_sharding
from worddiffusion_tpu.parallel.mesh import shard_batch as jax_shard
from worddiffusion_tpu.train import state as jstate
from worddiffusion_tpu.train import step as jstep
from chip_smoke import tp_param_check
from test_torch_copies import port_cfg
from test_torch_ddp import _close, _free_port
from test_torch_orbax import write_jax_run
from test_torch_train import CFG, T, _cli_files, _jax_params, _port_model, _port_sd, tiny_exp
from worddiffusion_tpu_torch.cli import train as train_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.configs.config import (
    DataConfig, DiffusionConfig, Experiment, TrainConfig, VAEConfig)
from worddiffusion_tpu_torch.data.dataset import LatentLookup, WordImageDataset
from worddiffusion_tpu_torch.data.gt import Sample, WriterRegistry
from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.parallel import distributed, mesh
from worddiffusion_tpu_torch.parallel.tensor import shard_state_dict, unshard
from worddiffusion_tpu_torch.train.checkpoint import CheckpointManager, restore_jax
from worddiffusion_tpu_torch.train.loop import Trainer
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-5
RESUME_LR = 1e-4  # the step after a JAX run's resume (tp_param_check's lr)
B = 4  # global batch
TP_CFG = dataclasses.replace(CFG, num_heads=4)  # 64 channels, 4 heads of 16
# block cases: (attn1_cross, fold_context, context length); the fold gate
# needs heads * L <= 32
BLOCK_CASES = {"cross": (True, False, 5), "phosc_self": (False, False, 20),
               "fold": (True, True, 6)}
WORDS = "the of and to in is was that".split()

WORKER = textwrap.dedent('''
    import dataclasses
    import json
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    sys.path.insert(0, sys.argv[2])
    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.configs.config import (
        DataConfig, DiffusionConfig, Experiment, MeshConfig, TrainConfig, UNetConfig, VAEConfig)
    from worddiffusion_tpu_torch.data.dataset import LatentLookup, WordImageDataset
    from worddiffusion_tpu_torch.data.gt import Sample, WriterRegistry
    from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
    from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule
    from worddiffusion_tpu_torch.models.attention import BasicTransformerBlock
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.parallel.distributed import initialize_multihost
    from worddiffusion_tpu_torch.parallel.mesh import make_mesh, param_spec, shard_batch, shard_rows
    from worddiffusion_tpu_torch.parallel import tensor
    from worddiffusion_tpu_torch.parallel.tensor import gather_state_dict, shard_state_dict
    from worddiffusion_tpu_torch.train.checkpoint import restore_jax
    from worddiffusion_tpu_torch.train.loop import Trainer
    from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
    from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

    torch.set_num_threads(1)
    out, data = sys.argv[1], int(sys.argv[3])
    z = np.load(out + "/inputs.npz")
    rank, world = initialize_multihost("cpu")
    mesh = make_mesh(MeshConfig(data=data, model=2))
    assert world == 2 * data and (mesh.data, mesh.model) == (data, 2)
    checked = []

    def check_replicated(sd):
        """Every replicated entry of sd bitwise equal across the model ranks."""
        for k, v in sd.items():
            if param_spec(k) is None:
                parts = [torch.empty_like(v) for _ in range(2)]
                dist.all_gather(parts, v.detach().contiguous(), group=mesh.model_group)
                assert torch.equal(parts[0], parts[1]), k
                checked.append(k)

    def save(name, sd):
        if rank == 0:
            np.savez(f"{out}/{name}.npz", **{k: v.detach().numpy() for k, v in sd.items()})

    # (a) a sharded block against the unsharded one, forward and every gradient
    P = "transformer_blocks.0."
    for case, (cross, fold, _) in (json.loads(str(z["cases"])) if data == 1 else {}).items():
        full_sd = {k.split(".", 2)[2]: torch.from_numpy(z[k]) for k in z.files
                   if k.startswith(f"blk.{case}.")}
        full, tp = (BasicTransformerBlock(32, 4, 8, 32, cross, torch.float32, fold_context=fold,
                                          mesh=m) for m in (None, mesh))
        full.load_state_dict(full_sd)
        tp.load_state_dict({k[len(P):]: v for k, v in
                            shard_state_dict({P + k: v for k, v in full_sd.items()}, mesh).items()})
        res = {}
        for name, block in (("full", full), ("tp", tp)):
            x = torch.from_numpy(z[f"x.{case}"]).requires_grad_()
            c = torch.from_numpy(z[f"c.{case}"]).requires_grad_()
            y = block(x, c)
            y.backward(torch.from_numpy(z[f"dy.{case}"]))
            grads = {P + k: p.grad for k, p in block.named_parameters()}
            if name == "tp":
                check_replicated({"y": y, "dx": x.grad, "dc": c.grad, **grads})
                grads = gather_state_dict(grads, mesh)
            res.update({f"{name}.y": y, f"{name}.dx": x.grad, f"{name}.dc": c.grad,
                        **{f"{name}.g.{k[len(P):]}": g for k, g in grads.items()}})
        save(f"block_{case}", res)

    # (b) two steps on JAX's batches and draws, this data rank's rows of each
    cfg = UNetConfig(**json.loads(str(z["unet"])))
    exp = Experiment(unet=cfg, diffusion=DiffusionConfig(num_steps=int(z["T"])),
                     data=DataConfig(max_chars=10, alphabet="eng_main", batch_size=4),
                     train=TrainConfig(lr=float(z["lr"]), save_path=out + "/run",
                                       ckpt_every_epochs=1, ema_warmup_steps=1, log_every=1),
                     mesh=MeshConfig(data=data, model=2))
    reduces = []  # the model axis's fp32 all-reduces, each by its tensors' count
    all_reduce = tensor._all_reduce_fp32
    tensor._all_reduce_fp32 = lambda ts, m: reduces.append(len(ts)) or all_reduce(ts, m)

    def two_steps(cfg):
        """Two steps of a sharded UNet of ``cfg`` from the inputs' weights ->
        (its state, the all-reduces they made)."""
        model = UNet(cfg, mesh)
        model.load_state_dict(shard_state_dict(
            {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}, mesh))
        state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                        exp.train.weight_decay))
        rows = shard_rows(4, mesh) if data > 1 else None
        ddp = DistributedDataParallel(model, process_group=mesh.data_group) if data > 1 else None
        step = make_train_step(NoiseSchedule.linear(exp.diffusion.num_steps), exp, forward=ddp,
                               rows=rows, world=data)
        reduces.clear()
        for s in range(2):
            batch = {k: torch.from_numpy(z[f"b{s}.{k}"]) for k in ("latent", "context", "writer")}
            t, n = torch.from_numpy(z[f"t{s}"]), torch.from_numpy(z[f"n{s}"])
            if rows is not None:
                batch, t, n = shard_batch(batch, mesh), t[rows], n[rows]
            step(state, batch, StepDraws(t, n, torch.tensor(float(z[f"k{s}"]))))
        return state, len(reduces)

    state, n_reduces = two_steps(cfg)
    model = state.model
    check_replicated(model.state_dict())
    check_replicated(state.ema.state_dict())
    save("steps", gather_state_dict(model.state_dict(), mesh))
    if data == 1:  # (b') the same steps with remat: bitwise, the recompute's collectives counted
        remat, n_remat = two_steps(dataclasses.replace(cfg, remat=True))
        for (k, a), b in zip(model.named_parameters(), remat.model.parameters()):
            assert torch.equal(a, b), f"remat changed {k} on rank {rank}"
        if rank == 0:
            with open(out + "/reduces.json", "w") as f:
                json.dump({"plain": n_reduces, "remat": n_remat}, f)

    # (c) the Trainer's own run: 8 samples from a latent cache, 2 steps; then a
    # max_steps stop after step 1 and a resume: bitwise the uninterrupted run
    samples = [Sample(f"s{i}.png", str(i % 3), w) for i, w in enumerate(z["words"].tolist())]
    registry = WriterRegistry()
    for s in samples:
        registry.add(s.writer)
    ds = WordImageDataset(samples, registry, Tokenizer.from_name("eng_main", 10), exp.data,
                          latent_cache=LatentLookup({s.image: z["cache"][i]
                                                     for i, s in enumerate(samples)}))
    if data == 1:
        final = Trainer(exp, ds, device="cpu").run(epochs=1)
        save("trainer", gather_state_dict(final.model.state_dict(), mesh))
        again = exp.replace(train=dataclasses.replace(exp.train, save_path=out + "/resume"))
        assert Trainer(again, ds, device="cpu").run(epochs=1, max_steps=1).step == 1
        resumed = Trainer(again, ds, device="cpu").run(epochs=1, resume=True)
        assert resumed.step == 2
        for a, b in zip(list(resumed.model.parameters()) + list(resumed.ema.parameters()),
                        list(final.model.parameters()) + list(final.ema.parameters())):
            assert torch.equal(a, b), "the resumed TP run is not bitwise the uninterrupted one"

    # (e) a JAX run's orbax step resumed under the model axis: this rank's
    # restore, then the Trainer's next step (gathered)
    if data == 1:
        rcfg = UNetConfig(**json.loads(str(z["resume_unet"])))
        rmodel = UNet(rcfg, mesh)
        restored = restore_jax(TrainState.create(rmodel, make_optimizer(rmodel.parameters(), 1e-4)),
                               str(z["jax_step"]), mesh)
        opt = restored.optimizer.state_dict()["state"]
        names = [n for n, _ in rmodel.named_parameters()]
        np.savez(f"{out}/restored.{rank}.npz", step=restored.step,
                 **{f"model.{k}": v.numpy() for k, v in rmodel.state_dict().items()},
                 **{f"ema.{k}": v.numpy() for k, v in restored.ema.state_dict().items()},
                 **{f"{m}.{n}": opt[i][m].numpy() for i, n in enumerate(names)
                    for m in ("exp_avg", "exp_avg_sq", "step")})
        rexp = Experiment(unet=rcfg, diffusion=exp.diffusion, data=exp.data,
                          train=TrainConfig(lr=float(z["resume_lr"]), save_path=str(z["resume_tp"]),
                                            ckpt_every_epochs=1, ema_warmup_steps=1, log_every=1),
                          mesh=MeshConfig(data=1, model=2))
        resumed = Trainer(rexp, ds, device="cpu").run(epochs=5, max_steps=9, resume=True)
        assert resumed.step == 9, resumed.step
        save("resumed", {**gather_state_dict(resumed.model.state_dict(), mesh),
                         **{f"ema.{k}": v for k, v in
                            gather_state_dict(resumed.ema.state_dict(), mesh).items()}})

    # (d) the train CLI, as a user runs it
    presets.PRESETS["tiny_tp"] = lambda: Experiment(
        unet=cfg, diffusion=DiffusionConfig(num_steps=int(z["T"])), data=DataConfig(max_chars=10),
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                      dtype="float32"))
    cli = train_cli.main(json.loads(str(z["cli_argv"])) + [
        "--mesh_data", str(data), "--mesh_model", "2", "--save_path", out + "/cli"])
    assert cli.step == 2
    check_replicated(cli.model.state_dict())
    save("cli", gather_state_dict(cli.model.state_dict(), mesh))
    if rank == 0:
        with open(out + "/checked.json", "w") as f:
            json.dump(checked, f)
''')


def _random_tree(shapes, seed):
    """Random parameters of a Flax tree's shapes: norms near identity,
    lecun-scaled kernels, small biases; every one nonzero."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        r = rng.standard_normal(s.shape)
        if name == "scale":
            return (1 + 0.1 * r).astype(np.float32)
        if name == "bias":
            return (0.1 * r).astype(np.float32)
        return (r / np.sqrt(s.shape[0])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _block_to_port(tree, attn1_cross):
    """A Flax block tree (parameters or gradients) in the port block's keys."""
    out = {}
    for a in ("attn1", "attn2"):
        jconvert._inv_attn(tree[a], f"b.{a}", out)
    for n in ("norm2", "norm3") + (() if attn1_cross else ("norm1",)):
        jconvert._inv_norm(tree[n], f"b.{n}", out)
    jconvert._inv_dense(tree["ff"]["GEGLU_0"]["Dense_0"], "b.ff.net.0.proj", out)
    jconvert._inv_dense(tree["ff"]["Dense_0"], "b.ff.net.2", out)
    return {k[2:]: v for k, v in out.items()}


def _jax_block(case):
    """The JAX block's weights, inputs, output and gradients (jitted)."""
    cross, fold, n_ctx = BLOCK_CASES[case]
    blk = JaxBlock(dim=32, n_heads=4, d_head=8, context_dim=32, attn1_cross=cross,
                   dtype=jnp.float32, fold_context=fold)
    rng = np.random.default_rng(20 + len(case))
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    c = rng.standard_normal((2, n_ctx, 32)).astype(np.float32)
    dy = rng.standard_normal((2, 16, 32)).astype(np.float32)
    params = _random_tree(jax.eval_shape(blk.init, jax.random.PRNGKey(0), x, c), seed=7)
    y = jax.jit(blk.apply)(params, x, c)
    grads = jax.jit(jax.grad(lambda p, xx, cc: jnp.sum(blk.apply(p, xx, cc) * dy),
                             argnums=(0, 1, 2)))(params, x, c)
    gp, gx, gc = jax.device_get(grads)
    return dict(sd=_block_to_port(params["params"], cross), x=x, c=c, dy=dy,
                y=np.asarray(y), dx=gx, dc=gc, grads=_block_to_port(gp["params"], cross))


def _jax_steps(exp, params, data, batches, draws):
    """JAX's two jitted steps on a (data, 2) mesh from these draws' key."""
    jmesh = jax_make_mesh(JaxMesh(data=data, model=2))
    assert dict(jmesh.shape) == {"data": data, "model": 2}
    tx = jstate.make_optimizer(exp.train.lr, exp.train.weight_decay)
    state = jstate.TrainState.create(params, tx)
    step = jstep.jit_train_step(
        jstep.make_train_step(JaxUNet(exp.unet), NoiseSchedule.linear(T), exp, tx), jmesh, state)
    for b in batches:
        state, _ = step(state, jax_shard(b, jmesh), jax.random.PRNGKey(11))
    return _port_sd(jax.device_get(state.params), exp.unet)


def _draws(exp, batches):
    """JAX's draws of each step (what its step draws from PRNGKey(11))."""
    sched = NoiseSchedule.linear(T)
    out = []
    for s in range(len(batches)):
        t_rng, n_rng, d_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(11), s), 3)
        out.append((np.asarray(jforward.sample_timesteps(sched, t_rng, B)),
                    np.asarray(jax.random.normal(n_rng, (B, 8, 32, 4), jnp.float32)),
                    float(jax.random.uniform(d_rng, ()) >= exp.train.cfg_drop_prob)))
    return out


def _tiny_tp_preset():
    return Experiment(
        unet=port_cfg(TP_CFG), diffusion=DiffusionConfig(num_steps=T),
        data=DataConfig(max_chars=10),
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                      dtype="float32"))


def _cli_argv(gt, cache):
    return ["--preset", "tiny_tp", "--gt_train", gt, "--latent_cache", cache, "--batch_size",
            str(B), "--epochs", "1", "--ckpt_every_epochs", "1", "--preview_ddim", "2", "--lr",
            str(LR), "--device", "cpu"]


def _launch(tmp, data):
    """Everything the worker needs, then torchrun over 2 * data gloo ranks;
    -> the parent's side of the comparison."""
    exp = tiny_exp(str(tmp / "one"), lr=LR, ema_warmup_steps=1, log_every=1)
    exp = exp.replace(unet=TP_CFG)
    params = _jax_params(cfg=TP_CFG)
    rng = np.random.default_rng(4)
    batches = [{"latent": rng.standard_normal((B, 8, 32, 4)).astype(np.float32),
                "context": rng.integers(0, 53, (B, 10)).astype(np.int32),
                "writer": rng.integers(0, 8, B).astype(np.int32)} for _ in range(2)]
    draws = _draws(exp, batches)
    sd = _port_sd(params, TP_CFG)
    blocks = {case: _jax_block(case) for case in BLOCK_CASES} if data == 1 else {}
    cache = np.random.default_rng(9).standard_normal((8, 8, 32, 4)).astype(np.float32)
    gt, lat = _cli_files(tmp, n=2 * B)
    def unet_kw(cfg):
        return {k: getattr(port_cfg(cfg), k) for k in (
            "model_channels", "context_dim", "num_heads", "vocab_size", "num_writers",
            "max_seq_len", "dtype")}

    # at 1x2: a JAX run to resume (its --save_path copied for each side)
    jax_run = write_jax_run(tmp / "jax_run") if data == 1 else None
    for side in ("resume_tp", "resume_one"):
        if jax_run:
            shutil.copytree(os.path.join(jax_run["root"], "run"), tmp / side)
    np.savez(tmp / "inputs.npz", unet=json.dumps(unet_kw(TP_CFG)), T=T, lr=LR, cache=cache,
             resume_unet=json.dumps(unet_kw(CFG)), resume_lr=RESUME_LR,
             resume_tp=str(tmp / "resume_tp"),
             jax_step=os.path.join(jax_run["ckpt"], "8") if jax_run else "",
             words=np.array(WORDS), cases=json.dumps(BLOCK_CASES),
             cli_argv=json.dumps(_cli_argv(gt, lat)),
             **{f"sd.{k}": v for k, v in sd.items()},
             **{f"blk.{case}.{k}": v for case, j in blocks.items() for k, v in j["sd"].items()},
             **{f"{a}.{case}": j[a] for case, j in blocks.items() for a in ("x", "c", "dy")},
             **{f"b{s}.{k}": v.astype(np.int64) if v.dtype == np.int32 else v
                for s, b in enumerate(batches) for k, v in b.items()},
             **{f"t{s}": d[0].astype(np.int64) for s, d in enumerate(draws)},
             **{f"n{s}": d[1] for s, d in enumerate(draws)},
             **{f"k{s}": d[2] for s, d in enumerate(draws)})
    script = tmp / "tp_worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(2 * data),
           "--master_addr", "localhost", "--master_port", str(_free_port()), str(script),
           str(tmp), REPO, str(data)]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-6000:]
    return dict(tmp=tmp, exp=exp, params=params, batches=batches, draws=draws, sd=sd,
                blocks=blocks, cache=cache, gt=gt, lat=lat, jax_run=jax_run,
                jax=_jax_steps(exp, params, data, batches, draws))


@pytest.fixture(scope="module")
def tp_1x2(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("tp_1x2"), data=1)


@pytest.fixture(scope="module")
def tp_2x2(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("tp_2x2"), data=2)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_sharded_block_matches_unsharded_and_jax(tp_1x2, case):
    """The block sharded over 2 model ranks (2 heads and half the FF width
    each) equals the unsharded port block and the JAX block on the same
    weights: the output, dx, d(context) and every parameter gradient."""
    got = np.load(tp_1x2["tmp"] / f"block_{case}.npz")
    j = tp_1x2["blocks"][case]
    for name, want in (("y", j["y"]), ("dx", j["dx"]), ("dc", j["dc"])):
        assert _max_rel(got[f"tp.{name}"], got[f"full.{name}"]) <= 1e-5, (case, name)
        assert _max_rel(got[f"tp.{name}"], want) <= 1e-4, (case, name)
    keys = {k[5:] for k in got.files if k.startswith("tp.g.")}
    assert keys == set(j["grads"]) == {k[7:] for k in got.files if k.startswith("full.g.")}
    for k in keys:
        assert _max_rel(got[f"tp.g.{k}"], got[f"full.g.{k}"]) <= 1e-5, (case, k)
        assert _max_rel(got[f"tp.g.{k}"], j["grads"][k]) <= 1e-4, (case, k)
    assert np.abs(got["tp.dc"]).max() > 0  # the context's gradient reached it


@pytest.mark.parametrize("grid", ["tp_1x2", "tp_2x2"])
def test_tp_train_step_matches_one_process_and_jax_mesh(grid, request):
    """Two steps at MeshConfig(data, model=2) on JAX's batches and draws
    (each data rank its rows; DDP over the data group at data 2): the
    gathered parameters equal the one-process port steps on the global
    batches and JAX's jitted steps on the same mesh."""
    run = request.getfixturevalue(grid)
    pexp = port_cfg(run["exp"])
    model = _port_model(run["params"], TP_CFG)
    state = TrainState.create(model, make_optimizer(model.parameters(), LR,
                                                    pexp.train.weight_decay))
    step = make_train_step(PortSchedule.linear(T), pexp)
    for b, (t, n, k) in zip(run["batches"], run["draws"]):
        step(state, {key: torch.from_numpy(v).long() if v.dtype == np.int32 else
                     torch.from_numpy(v) for key, v in b.items()},
             StepDraws(torch.from_numpy(t).long(), torch.from_numpy(n), torch.tensor(k)))
    one = {k: v.numpy() for k, v in model.state_dict().items()}
    tp = np.load(run["tmp"] / "steps.npz")
    assert set(tp.files) == set(one) == set(run["jax"])
    moved = 0
    for k in one:
        assert tp[k].shape == one[k].shape, k
        _close(tp[k], one[k], k)
        _close(tp[k], run["jax"][k], k)
        moved += np.abs(one[k] - run["sd"][k]).max() > LR / 2
    assert moved > len(one) // 2  # the steps moved most tensors


@pytest.mark.parametrize("grid", ["tp_1x2", "tp_2x2"])
def test_replicated_entries_bitwise_equal_across_model_ranks(grid, request):
    """The worker all-gathers every replicated parameter (after the steps,
    the EMA's, the CLI run's) and, at 1x2, each block's outputs and
    replicated gradients over the model group and asserts them bitwise
    equal: the ranks run the same arithmetic on the same inputs."""
    run = request.getfixturevalue(grid)
    with open(run["tmp"] / "checked.json") as f:
        checked = json.load(f)
    n_rep = sum(mesh.param_spec(k) is None for k in run["sd"])
    assert 0 < n_rep < len(run["sd"])
    assert len(checked) >= 3 * n_rep + (3 * 3 if grid == "tp_1x2" else 0)
    assert "time_embed.0.weight" in checked and not any(
        mesh.param_spec(k) for k in checked)


def test_tp_trainer_resumes_bitwise_and_its_checkpoint_loads_in_one_process(tp_1x2):
    """The Trainer at 1x2 (its own draws) equals the one-process Trainer;
    its max_steps stop and resume were bitwise (asserted by the worker); its
    checkpoint, written gathered by rank 0, has the one-process keys and
    shapes, loads into a one-process state and holds the run's parameters
    bitwise; the EMA file loads as a one-process UNet."""
    tmp, pexp = tp_1x2["tmp"], port_cfg(tp_1x2["exp"])
    samples = [Sample(f"s{i}.png", str(i % 3), w) for i, w in enumerate(WORDS)]
    registry = WriterRegistry()
    for s in samples:
        registry.add(s.writer)
    data = dataclasses.replace(pexp.data, batch_size=B)
    ds = WordImageDataset(samples, registry, Tokenizer.from_name("eng_main", 10), data,
                          latent_cache=LatentLookup({s.image: tp_1x2["cache"][i]
                                                     for i, s in enumerate(samples)}))
    single = Trainer(pexp.replace(data=data), ds, device="cpu").run(epochs=1)
    tp = np.load(tmp / "trainer.npz")
    for k, v in single.model.state_dict().items():
        _close(tp[k], v.numpy(), k)

    ck = CheckpointManager(str(tmp / "run" / "ckpt"))
    assert ck.steps() == [2]
    model = UNet(single.model.cfg)
    state = TrainState.create(model, make_optimizer(model.parameters(), LR))
    ck.restore(state)
    assert state.step == 2
    for k, v in model.state_dict().items():
        assert torch.equal(v, torch.from_numpy(tp[k])), k
    saved = torch.load(ck.path(2), weights_only=True)
    ref = single.optimizer.state_dict()["state"]
    assert set(saved["optimizer"]["state"]) == set(ref)
    for i, st in ref.items():
        for name, v in st.items():
            assert saved["optimizer"]["state"][i][name].shape == v.shape, (i, name)
    UNet(single.model.cfg).load_state_dict(torch.load(ck.path(2, "ema_unet.pt")), strict=True)


def test_tp_remat_steps_are_bitwise_and_recompute_the_forward_reduces(tp_1x2):
    """The worker took the two steps again with ``remat=True`` on both ranks
    and asserted every parameter bitwise the steps' without it. The model
    axis's fp32 all-reduces: without remat 24 a step (each of the 4 blocks
    sums 3 partials forward, attn1, attn2 and the FF, and 3 inputs' gradients
    backward); with it, the backward's recompute of each block sums attn1's
    and attn2's partials again: 8 more a step, the same on every rank. The
    FF's forward sum is not repeated: the recompute stops once it has made
    the last tensor the backward reads (the FF's saved input), which comes
    before it."""
    with open(tp_1x2["tmp"] / "reduces.json") as f:
        reduces = json.load(f)
    assert reduces == {"plain": 2 * 24, "remat": 2 * (24 + 8)}, reduces


def test_tp_resumes_a_jax_run(tp_1x2):
    """The JAX Trainer's orbax step 8 resumed under ``--mesh_model 2``:
    each rank's model, EMA, AdamW moments and count are exactly
    ``shard_state_dict`` of the one-process ``restore_jax`` (a moment keyed
    by its parameter's name takes the parameter's layout); the Trainer's
    next step (step 9, lr 1e-4) matches the one-process resumed step within
    ``chip_smoke.tp_param_check``'s bounds, the model and the EMA."""
    tmp, jax_run = tp_1x2["tmp"], tp_1x2["jax_run"]
    cfg = port_cfg(CFG)
    model = UNet(cfg)
    state = restore_jax(TrainState.create(model, make_optimizer(model.parameters(), 1e-4)),
                        os.path.join(jax_run["ckpt"], "8"))
    assert state.step == 8
    opt = state.optimizer.state_dict()["state"]
    names = [n for n, _ in model.named_parameters()]
    full = {"model": model.state_dict(), "ema": state.ema.state_dict(),
            **{m: {n: opt[i][m] for i, n in enumerate(names)}
               for m in ("exp_avg", "exp_avg_sq")}}
    for r in range(2):
        got = np.load(tmp / f"restored.{r}.npz")
        assert int(got["step"]) == 8
        rank = mesh.Mesh(data=1, model=2, model_rank=r)
        for part, sd in full.items():
            shards = shard_state_dict(sd, rank)
            assert {k[len(part) + 1:] for k in got.files if k.startswith(part + ".")} == set(sd)
            for k, v in shards.items():
                assert got[f"{part}.{k}"].tobytes() == v.numpy().tobytes(), (r, part, k)
        assert all(float(got[f"step.{n}"]) == float(opt[i]["step"]) == 8.0
                   for i, n in enumerate(names))

    samples = [Sample(f"s{i}.png", str(i % 3), w) for i, w in enumerate(WORDS)]
    registry = WriterRegistry()
    for s in samples:
        registry.add(s.writer)
    exp = Experiment(unet=cfg, diffusion=DiffusionConfig(num_steps=T),
                     data=DataConfig(max_chars=10, alphabet="eng_main", batch_size=B),
                     train=TrainConfig(lr=RESUME_LR, save_path=str(tmp / "resume_one"),
                                       ckpt_every_epochs=1, ema_warmup_steps=1, log_every=1))
    ds = WordImageDataset(samples, registry, Tokenizer.from_name("eng_main", 10), exp.data,
                          latent_cache=LatentLookup({s.image: tp_1x2["cache"][i]
                                                     for i, s in enumerate(samples)}))
    one = Trainer(exp, ds, device="cpu").run(epochs=5, max_steps=9, resume=True)
    assert one.step == 9
    tp = np.load(tmp / "resumed.npz")
    for prefix, module, start in (("", one.model, full["model"]), ("ema.", one.ema, full["ema"])):
        got = {k: torch.from_numpy(tp[prefix + k]) for k in start}
        report = tp_param_check(got, module.state_dict(), start)
        assert report["tensors"] > len(start) // 2, report


@pytest.mark.parametrize("grid", ["tp_1x2", "tp_2x2"])
def test_train_cli_trains_tensor_parallel(grid, request, monkeypatch):
    """``torchrun ... cli.train --mesh_model 2`` (and ``--mesh_data 2``) on
    gloo CPU ranks: 2 steps from a latent cache with a checkpoint and a
    sharded DDIM preview; the gathered parameters equal the one-process CLI
    run's, the preview grid is written once, by rank 0."""
    run = request.getfixturevalue(grid)
    monkeypatch.setitem(presets.PRESETS, "tiny_tp", _tiny_tp_preset)
    state = train_cli.main(_cli_argv(run["gt"], run["lat"]) + [
        "--save_path", str(run["tmp"] / "cli_one")])
    tp = np.load(run["tmp"] / "cli.npz")
    for k, v in state.model.state_dict().items():
        _close(tp[k], v.numpy(), k)
    assert os.listdir(run["tmp"] / "cli" / "images") == ["epoch_0000.png"]
    assert sorted(os.listdir(run["tmp"] / "cli" / "ckpt")) == ["2"]


def _spec_codes(params, jmesh):
    """JAX's layout of every UNet parameter as a tree of arrays of the
    parameters' shapes filled with 0 (replicated), 1 (P(None, 'model')) or
    2 (P('model', None)), so that the port's key mapping carries it."""
    codes = {jax.sharding.PartitionSpec(): 0, jax.sharding.PartitionSpec(None, "model"): 1,
             jax.sharding.PartitionSpec("model", None): 2}
    specs = param_sharding(params, jmesh)
    return jax.tree_util.tree_map(lambda p, s: np.full(p.shape, codes[s.spec], np.float32),
                                  params, specs)


def test_param_spec_matches_jax_param_sharding():
    """``param_spec`` against JAX's ``param_sharding`` on a MeshConfig(data=4,
    model=2) mesh, every UNet parameter (the CTC head and glyph encoder
    too): q/k/v and the GEGLU in-projection column-parallel, ``to_out``
    row-parallel, everything else replicated, but for the one recorded
    difference: JAX's row pattern misses the FF out-projection
    (``ff/Dense_0/Dense_0/kernel``), which it keeps replicated and the port
    cuts by rows (ROADMAP C). The port's in-projection is "geglu_col": the
    same axis cut, the halves interleaved."""
    cfg = dataclasses.replace(TP_CFG, ocr_head=True, ocr_hidden=32, ocr_layers=1,
                              use_char_images=True)
    params = _jax_params(cfg=cfg, extra={"char_images": np.zeros((2, 10, 16, 16, 1), np.float32)})
    ported = _port_sd(_spec_codes(params, jax_make_mesh(JaxMesh(data=4, model=2))), cfg)
    assert set(ported) == set(UNet(port_cfg(cfg)).state_dict())
    want = {0: None, 1: "col", 2: "row"}
    differ = []
    for key, code in ported.items():
        jax_spec, ours = want[int(code.flat[0])], mesh.param_spec(key)
        if ours == "geglu_col":
            ours = "col"
        if jax_spec != ours:
            differ.append((key, jax_spec, mesh.param_spec(key)))
    assert sorted(differ) == sorted((k, None, "row") for k in ported if k.endswith("ff.net.2.weight"))
    assert len(differ) == 4  # the FF of each of the 4 blocks
    assert sum(mesh.param_spec(k) == "geglu_col" for k in ported) == 4


@pytest.mark.parametrize("model", [2, 4])
def test_shard_and_unshard_round_trip_bitwise(model):
    """Each rank's shard of a full UNet state dict has the sharded model's
    shapes; the shards join back bitwise; geglu_col gives rank r the r-th
    slice of each GEGLU half."""
    cfg = port_cfg(TP_CFG)
    full = UNet(cfg).state_dict()
    g = torch.Generator().manual_seed(0)
    full = {k: torch.randn(v.shape, generator=g) for k, v in full.items()}
    parts = [shard_state_dict(full, mesh.Mesh(data=1, model=model, model_rank=r))
             for r in range(model)]
    local = UNet(cfg, mesh.Mesh(data=1, model=model)).state_dict()
    for p in parts:
        assert {k: v.shape for k, v in p.items()} == {k: v.shape for k, v in local.items()}
    joined = {k: unshard([p[k] for p in parts], mesh.param_spec(k)) for k in parts[0]}
    assert all(torch.equal(joined[k], v) for k, v in full.items())
    key = next(k for k in full if k.endswith("ff.net.0.proj.weight"))
    inner = full[key].shape[0] // 2
    n = inner // model
    assert torch.equal(parts[1][key], torch.cat([full[key][n:2 * n],
                                                 full[key][inner + n:inner + 2 * n]]))


@pytest.mark.parametrize("heads,channels,model,match", [
    (4, 64, 3, "num_heads 4 is not divisible by the model axis 3"),
    (2, 24, 4, "num_heads 2 is not divisible by the model axis 4"),
])
def test_unet_refuses_an_axis_that_does_not_divide(heads, channels, model, match):
    cfg = dataclasses.replace(port_cfg(TP_CFG), num_heads=heads, model_channels=channels)
    with pytest.raises(ValueError, match=match):
        UNet(cfg, mesh.Mesh(data=1, model=model))


def test_unet_refuses_attention_maps_under_a_model_axis():
    """``return_attn`` runs in one process; a sharded UNet refuses it rather
    than return each rank's heads' maps."""
    cfg = dataclasses.replace(port_cfg(TP_CFG), return_attn=True)
    with pytest.raises(ValueError, match="return_attn needs the whole model in one process"):
        UNet(cfg, mesh.Mesh(data=1, model=2))
    assert len(UNet(cfg, mesh.Mesh(data=2))._attn_names) > 0


def test_ranks_of_a_model_group_hold_the_same_rows():
    """Rows are cut by the data rank: the two model ranks of data rank 1
    hold the same half of the batch."""
    rows = {(d, m): mesh.shard_rows(8, mesh.Mesh(data=2, model=2, data_rank=d, model_rank=m))
            for d in range(2) for m in range(2)}
    assert rows[0, 0] == rows[0, 1] == slice(0, 4)
    assert rows[1, 0] == rows[1, 1] == slice(4, 8)
    assert mesh.Mesh(data=2, model=2, data_rank=1, model_rank=1).rank == 3


def test_card_sharing_setting_maps_ranks_modulo_the_cards(monkeypatch):
    """With the setting, local rank r drives card r % count (card 0 for any
    rank on a machine with one card); without it, a rank beyond the cards
    raises (``tests/test_torch_ddp.py::test_mesh_refusals``)."""
    monkeypatch.setenv(distributed.SHARE_CARD_ENV, "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [distributed.card_index(r) for r in range(3)] == [0, 0, 0]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [distributed.card_index(r) for r in range(3)] == [0, 1, 0]
    monkeypatch.setenv(distributed.SHARE_CARD_ENV, "0")
    assert distributed.card_index(1) == 1
