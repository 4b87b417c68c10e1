"""Data parallelism across processes: ``parallel.distributed``,
``parallel.mesh``, ``data.loader.host_shard`` and the Trainer under
``DistributedDataParallel``.

The two-process runs go through ``torchrun`` (gloo on the CPU), as a user
launches them: each process steps on its rows of the global batch with the
global batch's draws, so after two steps its parameters equal the
one-process steps on the global batch and JAX's jitted step on a
``MeshConfig(data=2)`` mesh over this suite's 8 CPU devices (JAX's draws
handed in). The Trainer's own run (its draws, rank 0's checkpoint and
metrics, the broadcast stop flag) is held against the one-process run, and a
two-process run stopped after a step and resumed is bitwise the
uninterrupted one.

Tolerances (fp32): Adam's first updates are about ``lr * sign(g)``, so a
gradient that is rounding noise on both sides can move its parameter by up
to ``2 * lr`` a step however close the gradients are; lr is 1e-5 here, so
two steps bound every difference by 4e-5, and the test holds 99% of the
entries to 1e-7 besides.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs.config import MeshConfig as JaxMesh
from worddiffusion_tpu.data.loader import host_shard as jax_host_shard
from worddiffusion_tpu.diffusion import forward as jforward
from worddiffusion_tpu.diffusion.schedule import NoiseSchedule
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu.parallel.mesh import make_mesh as jax_make_mesh, shard_batch as jax_shard
from worddiffusion_tpu.train import state as jstate
from worddiffusion_tpu.train import step as jstep
from test_torch_copies import port_cfg
from test_torch_train import CFG, T, _jax_params, _port_model, _port_sd, tiny_exp
from worddiffusion_tpu_torch.configs.config import MeshConfig
from worddiffusion_tpu_torch.data.dataset import LatentLookup, WordImageDataset
from worddiffusion_tpu_torch.data.gt import Sample, WriterRegistry
from worddiffusion_tpu_torch.data.loader import host_shard
from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule as PortSchedule
from worddiffusion_tpu_torch.parallel import distributed, mesh
from worddiffusion_tpu_torch.train.loop import Trainer
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-5
B = 4  # global batch: 2 rows a process

WORKER = textwrap.dedent('''
    import dataclasses
    import json
    import sys
    import numpy as np
    import torch
    from torch.nn.parallel import DistributedDataParallel

    sys.path.insert(0, sys.argv[2])
    from worddiffusion_tpu_torch.configs.config import DataConfig, DiffusionConfig, Experiment
    from worddiffusion_tpu_torch.configs.config import TrainConfig, UNetConfig
    from worddiffusion_tpu_torch.data.dataset import LatentLookup, WordImageDataset
    from worddiffusion_tpu_torch.data.gt import Sample, WriterRegistry
    from worddiffusion_tpu_torch.data.tokenizer import Tokenizer
    from worddiffusion_tpu_torch.diffusion.schedule import NoiseSchedule
    from worddiffusion_tpu_torch.models.unet import UNet
    from worddiffusion_tpu_torch.parallel.distributed import initialize_multihost
    from worddiffusion_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_rows
    from worddiffusion_tpu_torch.train.loop import Trainer
    from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer
    from worddiffusion_tpu_torch.train.step import StepDraws, make_train_step

    torch.set_num_threads(1)
    out = sys.argv[1]
    z = np.load(out + "/inputs.npz")
    rank, world = initialize_multihost("cpu")
    assert world == 2
    cfg = UNetConfig(**json.loads(str(z["unet"])))
    exp = Experiment(unet=cfg, diffusion=DiffusionConfig(num_steps=int(z["T"])),
                     data=DataConfig(max_chars=10, alphabet="eng_main", batch_size=4),
                     train=TrainConfig(lr=float(z["lr"]), save_path=out + "/run",
                                       ckpt_every_epochs=1, ema_warmup_steps=1, log_every=1))
    m = make_mesh(exp.mesh)
    rows = shard_rows(4, m)

    # (a) two steps on JAX's batches and draws, this process's rows of each
    model = UNet(cfg)
    model.load_state_dict({k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")})
    state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr,
                                                    exp.train.weight_decay))
    ddp = DistributedDataParallel(model)
    step = make_train_step(NoiseSchedule.linear(exp.diffusion.num_steps), exp, forward=ddp,
                           rows=rows, world=world)
    for s in range(2):
        batch = shard_batch({k: torch.from_numpy(z[f"b{s}.{k}"]) for k in
                             ("latent", "context", "writer")}, m)
        draws = StepDraws(torch.from_numpy(z[f"t{s}"])[rows], torch.from_numpy(z[f"n{s}"])[rows],
                          torch.tensor(float(z[f"k{s}"])))
        step(state, batch, draws)
    if rank == 0:
        np.savez(out + "/steps.npz", **{k: v.numpy() for k, v in model.state_dict().items()})

    # (b) the Trainer's own run: 8 samples from a latent cache, 2 steps
    words = "the of and to in is was that".split()
    samples = [Sample(f"s{i}.png", str(i % 3), w) for i, w in enumerate(words)]
    registry = WriterRegistry()
    for s in samples:
        registry.add(s.writer)
    lat = LatentLookup({s.image: z["cache"][i] for i, s in enumerate(samples)})
    ds = WordImageDataset(samples, registry, Tokenizer.from_name("eng_main", 10), exp.data,
                          latent_cache=lat)
    trainer = Trainer(exp, ds, device="cpu")
    final = trainer.run(epochs=1)
    if rank == 0:
        np.savez(out + "/trainer.npz", **{k: v.numpy() for k, v in final.model.state_dict().items()})

    # (c) a max_steps stop after step 1 and a resume: bitwise the uninterrupted run
    again = exp.replace(train=dataclasses.replace(exp.train, save_path=out + "/resume"))
    assert Trainer(again, ds, device="cpu").run(epochs=1, max_steps=1).step == 1
    resumed = Trainer(again, ds, device="cpu").run(epochs=1, resume=True)
    assert resumed.step == 2
    for a, b in zip(resumed.model.parameters(), final.model.parameters()):
        assert torch.equal(a, b), "the resumed 2-process run is not bitwise the uninterrupted one"
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _torchrun(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()), str(script),
           str(tmp_path), REPO]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]


def _close(a, b, what):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.max() <= 4 * LR, (what, d.max())
    assert np.mean(d <= 1e-7) >= 0.99, (what, np.mean(d <= 1e-7))


def _inputs(exp, params):
    """Two global batches and JAX's two steps on a data=2 mesh (its state
    after them, and the draws of each step)."""
    rng = np.random.default_rng(4)
    batches = [{"latent": rng.standard_normal((B, 8, 32, 4)).astype(np.float32),
                "context": rng.integers(0, 53, (B, 10)).astype(np.int32),
                "writer": rng.integers(0, 8, B).astype(np.int32)} for _ in range(2)]
    sched = NoiseSchedule.linear(T)
    tx = jstate.make_optimizer(exp.train.lr, exp.train.weight_decay)
    jmesh = jax_make_mesh(JaxMesh(data=2))
    assert jmesh.shape["data"] == 2
    state = jstate.TrainState.create(params, tx)
    step = jstep.jit_train_step(jstep.make_train_step(JaxUNet(exp.unet), sched, exp, tx), jmesh,
                                state)
    rng_key = jax.random.PRNGKey(11)
    draws = []
    for s, b in enumerate(batches):
        t_rng, n_rng, d_rng = jax.random.split(jax.random.fold_in(rng_key, s), 3)
        draws.append((np.asarray(jforward.sample_timesteps(sched, t_rng, B)),
                      np.asarray(jax.random.normal(n_rng, (B, 8, 32, 4), jnp.float32)),
                      float(jax.random.uniform(d_rng, ()) >= exp.train.cfg_drop_prob)))
        state, _ = step(state, jax_shard(b, jmesh), rng_key)
    return batches, draws, state


def test_two_processes_match_one_process_and_jax_mesh(tmp_path):
    """torchrun, 2 gloo processes: two DDP steps on the rows of JAX's
    batches with JAX's draws = the one-process steps on the global batches =
    JAX's jitted steps on MeshConfig(data=2); and the Trainer's run (its
    own draws) = the one-process run, checkpoint and metrics from rank 0."""
    exp = tiny_exp(str(tmp_path / "one"), lr=LR, ema_warmup_steps=1, log_every=1)
    params = _jax_params(cfg=CFG)
    batches, draws, jnew = _inputs(exp, params)
    sd = _port_sd(params, CFG)
    cache = np.random.default_rng(9).standard_normal((8, 8, 32, 4)).astype(np.float32)
    unet_kw = {k: getattr(port_cfg(CFG), k) for k in ("model_channels", "context_dim",
                                                      "num_heads", "vocab_size", "num_writers",
                                                      "max_seq_len", "dtype")}
    np.savez(tmp_path / "inputs.npz", unet=json.dumps(unet_kw), T=T, lr=LR, cache=cache,
             **{f"sd.{k}": v for k, v in sd.items()},
             **{f"b{s}.{k}": v.astype(np.int64) if v.dtype == np.int32 else v
                for s, b in enumerate(batches) for k, v in b.items()},
             **{f"t{s}": d[0].astype(np.int64) for s, d in enumerate(draws)},
             **{f"n{s}": d[1] for s, d in enumerate(draws)},
             **{f"k{s}": d[2] for s, d in enumerate(draws)})
    _torchrun(tmp_path)

    # the one-process steps on the global batches
    pexp = port_cfg(exp)
    model = _port_model(params, CFG)
    state = TrainState.create(model, make_optimizer(model.parameters(), LR,
                                                    pexp.train.weight_decay))
    step = make_train_step(PortSchedule.linear(T), pexp)
    for b, (t, n, k) in zip(batches, draws):
        step(state, {key: torch.from_numpy(v).long() if v.dtype == np.int32 else
                     torch.from_numpy(v) for key, v in b.items()},
             StepDraws(torch.from_numpy(t).long(), torch.from_numpy(n), torch.tensor(k)))
    one = {k: v.numpy() for k, v in model.state_dict().items()}
    two = np.load(tmp_path / "steps.npz")
    want = _port_sd(jax.device_get(jnew.params), CFG)
    assert set(two.files) == set(one) == set(want)
    moved = 0
    for k in one:
        _close(two[k], one[k], k)
        _close(one[k], want[k], k)
        moved += np.abs(one[k] - sd[k]).max() > LR / 2
    assert moved > len(one) // 2  # the steps moved most tensors

    # the Trainer: 2 processes against 1, on its own draws
    words = "the of and to in is was that".split()
    samples = [Sample(f"s{i}.png", str(i % 3), w) for i, w in enumerate(words)]
    registry = WriterRegistry()
    for s in samples:
        registry.add(s.writer)
    ds = WordImageDataset(samples, registry, Tokenizer.from_name("eng_main", 10), pexp.data,
                          latent_cache=LatentLookup({s.image: cache[i]
                                                     for i, s in enumerate(samples)}))
    trainer = Trainer(pexp.replace(data=dataclasses.replace(pexp.data, batch_size=B)), ds,
                      device="cpu")
    single = {k: v.numpy() for k, v in trainer.run(epochs=1).model.state_dict().items()}
    multi = np.load(tmp_path / "trainer.npz")
    for k in single:
        _close(multi[k], single[k], k)
    run = tmp_path / "run"
    assert sorted(os.listdir(run / "ckpt")) == ["2"]
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2  # rank 0 alone logs, once a step (log_every 1)


def test_host_shard_matches_jax():
    samples = list(range(23))
    for n in (1, 2, 3, 4):
        shards = [host_shard(samples, i, n) for i in range(n)]
        assert shards == [jax_host_shard(samples, i, n) for i in range(n)]
        assert sorted(sum(shards, [])) == samples


def test_single_process_without_torchrun_env(monkeypatch):
    """No torchrun environment: one process, no group; the mesh spans it."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_multihost("cpu") == (0, 1)
    assert distributed.local_batch_slice(128) == 128
    assert distributed.local_device("cpu") == torch.device("cpu")
    m = mesh.make_mesh(MeshConfig(data=-1))
    assert (m.data, m.rank) == (1, 0)
    batch = {"x": np.arange(8), "w": ["a"] * 8, "keep": 1.0}
    assert mesh.shard_batch(batch, m)["x"].tolist() == list(range(8))


@pytest.mark.parametrize("make,error,match", [
    (lambda: mesh.make_mesh(MeshConfig(data=2)), ValueError,
     "--mesh_data 2 must equal the number of processes"),
    # a rank beyond the cards without the card-sharing setting (no card here)
    (lambda: distributed.card_index(1), RuntimeError, "has no card of its own.*"
     + distributed.SHARE_CARD_ENV),
    (lambda: mesh.make_mesh(MeshConfig(model=2)), ValueError,
     "--mesh_data -1 x --mesh_model 2 must equal the number of processes"),
])
def test_mesh_refusals(make, error, match, monkeypatch):
    monkeypatch.delenv(distributed.SHARE_CARD_ENV, raising=False)
    with pytest.raises(error, match=match):
        make()


def test_shard_rows_of_a_global_batch():
    """Data rank r holds rows [r*B/n, (r+1)*B/n), as JAX's P('data') places them."""
    parts = [mesh.shard_batch({"x": torch.arange(8), "y": np.arange(8) * 2, "s": 3},
                              mesh.Mesh(data=4, data_rank=r)) for r in range(4)]
    assert [p["x"].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [p["y"].tolist() for p in parts] == [[0, 2], [4, 6], [8, 10], [12, 14]]
    assert all(p["s"] == 3 for p in parts)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_rows(6, mesh.Mesh(data=4))


REGEN_WORKER = textwrap.dedent('''
    import sys

    import torch

    sys.path.insert(0, sys.argv[2])
    from worddiffusion_tpu_torch.cli import regenerate
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.configs.config import (
        DataConfig, DiffusionConfig, Experiment, UNetConfig, VAEConfig)

    torch.set_num_threads(1)
    presets.PRESETS["tiny_ddp"] = lambda: Experiment(
        unet=UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54,
                        num_writers=8, max_seq_len=10, dtype="float32"),
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=1,
                      dtype="float32"),
        diffusion=DiffusionConfig(num_steps=40), data=DataConfig(max_chars=10))
    regenerate.main(["--preset", "tiny_ddp", "--gt_file", sys.argv[1] + "/words.filter27",
                     "--dump_path", sys.argv[1] + "/" + sys.argv[3], "--batch_size", "2",
                     "--ddim", "2", "--no_ocr_filter", "1", "--device", "cpu"])
''')


def test_regeneration_across_processes_writes_the_one_process_set(tmp_path):
    """The regeneration CLI under torchrun, 2 gloo processes: each
    regenerates its ``host_shard`` of the gt file into the shared dump, and
    the files together are the names one process writes."""
    words = "the of and to in".split()
    (tmp_path / "words.filter27").write_text(
        "".join(f"{i % 3:03d},a01-{i:03d}u-00 {w}\n" for i, w in enumerate(words)))
    script = tmp_path / "regen_worker.py"
    script.write_text(REGEN_WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env["OMP_NUM_THREADS"] = "1"
    for procs, dump in ((2, "two"), (1, "one")):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(procs),
               "--master_addr", "localhost", "--master_port", str(_free_port()), str(script),
               str(tmp_path), REPO, dump]
        res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-4000:]
    two, one = (sorted(os.listdir(tmp_path / d)) for d in ("two", "one"))
    assert one == two == sorted(f"a01-{i:03d}u-00_{i % 3:03d}_{w}.png"
                                for i, w in enumerate(words))


def test_rows_of_the_global_draws_and_posterior_noise(monkeypatch):
    """A process's step draws the global batch's t, noise and, for an image
    batch encoded in the step, the VAE posterior's noise, and keeps its rows:
    rank 1 of 2 at B=2 sees rows 2-3 of the one-process draws at B=4."""
    from worddiffusion_tpu_torch.train.step import draw_step, step_generator

    exp = port_cfg(tiny_exp(cfg_drop_prob=0.3))
    sched = PortSchedule.linear(T)
    images = torch.zeros(2, 16, 64, 3)
    seen = {}

    def encode_fn(imgs, gen, noise=None):
        seen["noise"] = noise
        return torch.zeros(2, 2, 8, 4)

    def loss_spy(model, schedule, exp_, batch, draws):
        seen["draws"] = draws
        raise StopIteration

    import worddiffusion_tpu_torch.train.step as step_mod

    step = make_train_step(sched, exp, encode_fn, rows=slice(2, 4), world=2)
    lin = torch.nn.Linear(1, 1)
    state = TrainState(step=5, model=lin, optimizer=torch.optim.SGD(lin.parameters(), lr=0.1),
                       ema=None)
    monkeypatch.setattr(step_mod, "loss_fn", loss_spy)
    with pytest.raises(StopIteration):
        step(state, {"image": images})
    gen = step_generator(exp.train.seed, 5, "cpu")
    noise = torch.randn((4, 2, 8, 4), generator=gen)
    want = draw_step(sched, exp, torch.zeros(4, 2, 8, 4), gen)
    assert torch.equal(seen["noise"], noise[2:4])
    got = seen["draws"]
    assert torch.equal(got.t, want.t[2:4]) and torch.equal(got.noise, want.noise[2:4])
    assert torch.equal(got.keep, want.keep)


AUG_WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import torch

    sys.path.insert(0, sys.argv[2])
    from worddiffusion_tpu_torch.cli import train
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.configs.config import (
        DataConfig, DiffusionConfig, Experiment, UNetConfig)

    torch.set_num_threads(1)
    presets.PRESETS["tiny_aug"] = lambda: Experiment(
        unet=UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54,
                        num_writers=8, max_seq_len=10, dtype="float32"),
        diffusion=DiffusionConfig(num_steps=40), data=DataConfig(max_chars=10))
    state = train.main(sys.argv[4:] + ["--save_path", sys.argv[1] + "/" + sys.argv[3]])
    if torch.distributed.get_rank() == 0:
        np.savez(sys.argv[1] + "/aug.npz",
                 **{k: v.numpy() for k, v in state.model.state_dict().items()})
''')


def _aug_argv(gt, augment: int):
    return ["--preset", "tiny_aug", "--gt_train", gt, "--latent", "0", "--img_size", "16,64",
            "--augMaps", str(augment), "--batch_size", str(B), "--epochs", "1",
            "--ckpt_every_epochs", "1", "--preview_ddim", "2", "--lr", str(LR), "--device",
            "cpu"]


def test_augmented_training_across_processes_equals_one_process(tmp_path, monkeypatch):
    """``--augMaps 1`` (pixel space, rendered crops) under torchrun, 2 gloo
    processes: each image's augmentation is keyed by (seed, epoch, index),
    so the ranks, each loading its rows, augment as one process does, and
    the parameters after the run's 2 steps equal the one-process run's; an
    unaugmented run ends elsewhere."""
    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.configs.config import (
        DataConfig, DiffusionConfig, Experiment, UNetConfig)
    from test_torch_train import _cli_files

    gt, _ = _cli_files(tmp_path, n=2 * B)
    script = tmp_path / "aug_worker.py"
    script.write_text(AUG_WORKER)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE"))}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()), str(script),
           str(tmp_path), REPO, "two", *_aug_argv(gt, 1)]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]

    monkeypatch.setitem(presets.PRESETS, "tiny_aug", lambda: Experiment(
        unet=UNetConfig(model_channels=64, context_dim=32, num_heads=2, vocab_size=54,
                        num_writers=8, max_seq_len=10, dtype="float32"),
        diffusion=DiffusionConfig(num_steps=40), data=DataConfig(max_chars=10)))
    runs = {}
    for augment in (1, 0):
        state = train_cli.main(_aug_argv(gt, augment) + ["--save_path",
                                                          str(tmp_path / f"one{augment}")])
        assert state.step == 2
        runs[augment] = {k: v.numpy() for k, v in state.model.state_dict().items()}
    multi = np.load(tmp_path / "aug.npz")
    for k, v in runs[1].items():
        _close(multi[k], v, k)
    assert max(np.abs(runs[1][k] - runs[0][k]).max() for k in runs[1]) > 1e-7


def test_augmentation_draws_keyed_by_epoch_and_index():
    """An augmented image depends on (seed, epoch, index) alone: not on
    which images were loaded before it; another epoch draws anew."""
    from worddiffusion_tpu_torch.configs.config import DataConfig
    from worddiffusion_tpu_torch.data.augment import random_augment

    words = "the of and to in is was that".split()
    samples = [Sample(f"s{i}.png", "0", w) for i, w in enumerate(words)]
    registry = WriterRegistry()
    registry.add("0")
    cfg = DataConfig(max_chars=10, img_height=16, img_width=64)

    def ds(seed=0):
        return WordImageDataset(samples, registry, Tokenizer.from_name("eng_main", 10), cfg,
                                augment_fn=random_augment, seed=seed)

    a, b = ds(), ds()
    first = [a[i]["image"] for i in range(8)]
    backwards = [b[i]["image"] for i in reversed(range(8))][::-1]
    assert all(np.array_equal(x, y) for x, y in zip(first, backwards))
    b.set_epoch(1)
    assert not all(np.array_equal(x, b[i]["image"]) for i, x in enumerate(first))
    assert not all(np.array_equal(x, ds(seed=1)[i]["image"]) for i, x in enumerate(first))
