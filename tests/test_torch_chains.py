"""The port's chains (``worddiffusion_tpu_torch/chains``) against the JAX
repo's chain scripts, on the CPU.

- Stage lists: each ``scripts/*.sh`` is read as text (``\\`` continuations
  joined; ``PHOSC``, ``EV``, ``DIR`` and ``SEED`` expanded, the ``for SEED``
  loop unrolled; heredocs skipped) and its ``python -m
  worddiffusion_tpu.cli.<name>`` commands are held, in order, against the
  port chain's CLI steps as the runner resolves them: the same CLI, the same
  arguments, every ``runs/`` path under the runs directory, ``--device``
  appended.
- The ``python -`` blocks: each is run as the script's own text (JAX's
  renderer and Pillow) in a temporary directory, beside the port's step on
  the same inputs: the gt files byte-identical; the iam chain's 1280 real
  renders pixel-identical, both read back with ``data/png.read_png``; the
  comparison subsets identical over directories of empty files named as
  ``regenerate`` names them (a name both accepted and rejected included).
- A smoke of ``chains iam --smoke --device cpu`` at the tiny widths the
  other CLI tests use (``tiny_exp`` as the ``iam`` preset, its UNet at 16
  channels and its VAE at 8 a level, the narrow OCR, PHOSCNet at hidden 32 on a two-conv trunk in place of the
  13-conv VGG trunk, which a CPU cannot run over hundreds of crops within
  the test's time): every stage's artifact is written, a second run skips
  every stage, a deleted marker reruns that stage alone. The untrained
  filter accepts (almost) nothing, so a last run stands in for a trained
  one: half the ddim dump moved to its accepted side, the ``subsets`` and
  ``eval_*`` stages rerun alone, every subset filled and every ``evaluate``
  JSON holding a finite PHOSC FID.
- ``chains.eval_vae_ckpt`` against ``scripts/eval_vae_ckpt.py`` on one
  orbax ``<save_dir>/ckpt``: the same step and held-out MSE.
"""

import dataclasses
import functools
import json
import os
import re
import shlex
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_copies import port_cfg
from test_torch_side_trainers import _narrow_ocr
from test_torch_train import tiny_exp
from worddiffusion_tpu_torch.chains import blocks, run
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data.png import read_png
from worddiffusion_tpu_torch.models import phoscnet
from worddiffusion_tpu_torch.utils.images import regen_filename

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"iam": "iam_chain.sh", "gw": "gw_chain.sh", "cvl": "cvl_chain.sh",
           "nor": "nor_chain.sh", "nor_special": "nor_special_chain.sh",
           "higan": "higan_chain.sh", "style": "style_chain.sh",
           "phosc_gzsl": "phosc_syn5_gzsl.sh"}
JAX_CLI = "worddiffusion_tpu.cli."


def _script(name: str) -> list[str]:
    with open(os.path.join(ROOT, "scripts", SCRIPTS[name])) as f:
        return f.read().replace("\\\n", " ").splitlines()


def heredocs(name: str) -> list[str]:
    """The script's ``python - <<'PYEOF'`` blocks, in order."""
    out, body = [], None
    for line in _script(name):
        if body is not None:
            if line.strip() == "PYEOF":
                out.append("\n".join(body) + "\n")
                body = None
            else:
                body.append(line)
        elif "<<'PYEOF'" in line:
            body = []
    return out


def script_commands(name: str) -> list[tuple[str, list[str]]]:
    """The script's ``python -m worddiffusion_tpu.cli.<name> ...`` commands
    in order: (name, argv)."""
    env: dict = {}

    def expand(s: str) -> str:
        return re.sub(r"\$(\w+)", lambda m: env.get(m.group(1), m.group(0)), s)

    out: list = []

    def line_of(line: str) -> None:
        line = line.strip()
        cond = re.fullmatch(r'if \[ "\$(\w+)" = (\S+) \]; then (\w+)=(\S+); else \w+=(\S+); fi',
                            line)
        if cond:
            var, val, target, then, other = cond.groups()
            env[target] = expand(then if env.get(var) == val else other)
            return
        assign = re.fullmatch(r"(\w+)=(.+)", line)
        if assign:
            env[assign.group(1)] = shlex.split(expand(assign.group(2)))[0]
            return
        if line.startswith(("python -m", "$")):
            words = shlex.split(expand(line))
            if words[:2] == ["python", "-m"] and words[2].startswith(JAX_CLI):
                out.append((words[2][len(JAX_CLI):], words[3:]))

    lines, i, heredoc = _script(name), 0, False
    while i < len(lines):
        line = lines[i].strip()
        if heredoc:
            heredoc = line != "PYEOF"
        elif "<<'PYEOF'" in line:
            heredoc = True
        elif (loop := re.fullmatch(r"for (\w+) in (.+); do", line)):
            end = next(j for j in range(i + 1, len(lines)) if lines[j].strip() == "done")
            for value in loop.group(2).split():
                env[loop.group(1)] = value
                for body in lines[i + 1:end]:
                    line_of(body)
            i = end
        else:
            line_of(line)
        i += 1
    return out


def port_commands(chain: str, runs_dir: str) -> list[tuple[str, list[str]]]:
    out = []
    for stage in run.stages_of(chain):
        for step in stage.steps:
            if isinstance(step, run.Cli):
                argv = list(run.resolve(step, runs_dir, device="cuda").argv)
                assert argv[-2:] == ["--device", "cuda"], (chain, stage.name, argv)
                out.append((step.module, argv[:-2]))
    return out


@pytest.mark.parametrize("chain", run.CHAINS)
def test_chain_runs_the_scripts_commands(chain, tmp_path):
    """The same CLIs, with the same arguments, in the same order, every
    ``runs/`` path under the runs directory."""
    runs_dir = str(tmp_path / "r")
    jax = [(name, [run.rebase(a, runs_dir) for a in argv])
           for name, argv in script_commands(chain)]
    assert jax, chain
    port = port_commands(chain, runs_dir)
    assert port == jax
    # the runner's --smoke changes values of SMOKE's flags only
    for (_, argv), step in zip(port, (s for st in run.stages_of(chain) for s in st.steps
                                      if isinstance(s, run.Cli))):
        smoke = list(run.resolve(step, runs_dir, smoke=True).argv)
        assert len(smoke) == len(argv)
        assert all(a == b or smoke[i - 1] in run.SMOKE
                   for i, (a, b) in enumerate(zip(argv, smoke)))


def test_parser_reads_the_loop_and_variables():
    """The parser's expansions, on the two scripts that need them."""
    seeds = script_commands("phosc_gzsl")
    assert [a[a.index("--save_dir") + 1] for _, a in seeds] == [
        "runs/phosc_syn5", "runs/phosc_syn5", "runs/phosc_syn5_s1", "runs/phosc_syn5_s1"]
    evals = [a for n, a in script_commands("iam") if n == "evaluate"]
    assert len(evals) == 5 and all(a[:2] == ["--phosc_params", "runs/phosc_syn3/best_params.pkl"]
                                   for a in evals)


def run_jax_block(code: str, cwd) -> str:
    os.makedirs(os.path.join(cwd, "runs"), exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-"], input=code, cwd=cwd, env=env, text=True,
                         capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


# (chain, the gt file its first block writes, the port's step)
GT_BLOCKS = [
    ("iam", "demo_gt.csv", dict(vocab_size=10, samples_per_word=128)),
    ("gw", "gw_gt.csv", dict(vocab_size=10, samples_per_word=96, lang="gw")),
    ("cvl", "cvl_gt.csv", dict(vocab_size=10, samples_per_word=96, lang="cvl")),
    ("nor", "nor_gt.csv", dict(vocab_size=10, samples_per_word=96, lang="nor")),
    ("nor_special", "nor_special_gt.csv",
     dict(vocab_size=90, samples_per_word=48, lang="nor", special_only=True)),
    ("higan", "demo_gt.csv", dict(vocab_size=10, samples_per_word=128)),
]


@pytest.fixture(scope="module")
def iam_block(tmp_path_factory):
    """iam_chain.sh's stage-3b block run as its text."""
    cwd = tmp_path_factory.mktemp("jax_iam")
    run_jax_block(heredocs("iam")[0], cwd)
    return cwd


@pytest.mark.parametrize("chain,gt,kwargs", GT_BLOCKS, ids=[g[0] for g in GT_BLOCKS])
def test_gt_block_writes_the_same_file(chain, gt, kwargs, tmp_path, iam_block):
    """The port's gt step writes the script's gt file byte for byte, and the
    chain's own step has these arguments."""
    if chain == "iam":
        jax_dir = iam_block
    else:
        jax_dir = tmp_path / "jax"
        run_jax_block(heredocs(chain)[0], jax_dir)
    blocks.write_gt(str(tmp_path / gt), **kwargs)
    want = (jax_dir / "runs" / gt).read_bytes()
    assert want and (tmp_path / gt).read_bytes() == want
    step = next(s for st in run.stages_of(chain) for s in st.steps
                if isinstance(s, run.Py) and s.fn is blocks.write_gt)
    assert step.kwargs == {"out": f"runs/{gt}", **kwargs}


def test_real_renders_are_pixel_identical(tmp_path, iam_block):
    """The 1280 real renders of iam_chain.sh:52-58: the same names, the same
    pixels (PIL's PNGs and the port's, both read with ``read_png``)."""
    blocks.write_real_renders(str(tmp_path / "real"), 10, 128)
    jax_dir = iam_block / "runs" / "real_demo"
    names = sorted(os.listdir(jax_dir))
    assert len(names) == 1280 and sorted(os.listdir(tmp_path / "real")) == names
    for n in names:
        a, b = read_png(str(jax_dir / n)), read_png(str(tmp_path / "real" / n))
        assert a.shape == (64, 256, 3) and np.array_equal(a, b), n


def _regen_tree(root, seed: int, n_acc: int, n_rej: int, n_both: int):
    """runs/real_demo (the 1280 names), runs/regen_ddim and its rejected/ of
    empty files named as ``regenerate`` names them; ``n_both`` names in both."""
    from worddiffusion_tpu_torch.data.synthetic import synthetic_corpus, word_list

    samples = synthetic_corpus(words=word_list(10), samples_per_word=128)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(samples))
    acc, rej = order[:n_acc], order[n_acc:n_acc + n_rej]
    both = order[:n_both]
    dirs = {k: root / "runs" / p for k, p in (("real", "real_demo"), ("acc", "regen_ddim"),
                                              ("rej", "regen_ddim/rejected"))}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    for s in samples:
        (dirs["real"] / s.image).touch()
    for idx, d in ((acc, "acc"), (rej, "rej"), (both, "rej")):
        for i in idx:
            s = samples[i]
            (dirs[d] / regen_filename(s.image, s.writer, s.word)).touch()


SUBSETS = ("fid_floor_a", "fid_floor_b", "fid_unfilt", "fid_acc_bal", "fid_rej_bal")


@pytest.mark.parametrize("n_acc,n_rej,n_both", [(1107, 173, 12), (300, 980, 0), (0, 1280, 0)])
def test_subsets_block_picks_the_same_files(n_acc, n_rej, n_both, tmp_path):
    """iam_chain.sh:88-135 as its text and the port's step over the same
    directories: the same five subsets, file for file."""
    for side in ("jax", "port"):
        _regen_tree(tmp_path / side, 7, n_acc, n_rej, n_both)
    out = run_jax_block(heredocs("iam")[1], tmp_path / "jax")
    step = next(s for st in run.stages_of("iam") for s in st.steps
                if isinstance(s, run.Py) and s.fn is blocks.comparison_subsets)
    port = run.resolve(step, str(tmp_path / "port" / "runs"))
    counts = port.fn(**port.kwargs)
    assert f"accepted={counts['accepted']} rejected={counts['rejected']}" in out
    for d in SUBSETS:
        want = sorted(os.listdir(tmp_path / "jax" / "runs" / d))
        assert sorted(os.listdir(tmp_path / "port" / "runs" / d)) == want, d
    if n_acc:
        assert len(os.listdir(tmp_path / "port" / "runs" / "fid_unfilt")) == n_acc


@pytest.fixture
def tiny_chain(monkeypatch):
    """The iam preset at tiny width (a 16-channel UNet, an 8-channel VAE), the
    narrow OCR, a
    PHOSCNet of hidden 32 on a trunk of two 8-channel convs."""
    exp = port_cfg(tiny_exp())
    exp = dataclasses.replace(exp, unet=dataclasses.replace(exp.unet, model_channels=16),
                              vae=dataclasses.replace(exp.vae, base_channels=8,
                                                      channel_mult=(1, 1, 1, 1)))
    monkeypatch.setitem(presets.PRESETS, "iam", lambda: exp)
    _narrow_ocr(monkeypatch)
    monkeypatch.setattr(phoscnet._VGGTrunk, "PLAN", ((8, True), (8, True)))
    monkeypatch.setattr(phoscnet._VGGTrunk, "out_channels", 8)
    monkeypatch.setattr(phoscnet, "PHOSCNet", functools.partial(phoscnet.PHOSCNet, hidden=32,
                                                                dtype=torch.float32))


EVALS = ("realfloor", "filtered", "unfilt", "accbal", "rejbal")
ARTIFACTS = ("ocr_syn/ocr.pt", "vae_syn/vae.pt", "latents_demo.npz",
             "demo_latent/ckpt/1/state.pt", "demo_latent/writers_dict_train.json",
             "demo_gt.csv", "real_demo", "regen_demo", "regen_full", "regen_ddim/rejected",
             *SUBSETS, "phosc_syn3/best_params.pkl",
             *(f"eval_fid_{k}.json" for k in EVALS))


def test_iam_chain_smoke_resumes_by_stage(tiny_chain, tmp_path):
    runs_dir = str(tmp_path / "runs")
    argv = ["iam", "--runs_dir", runs_dir, "--device", "cpu", "--smoke"]
    first = run.main(argv)
    names = [s.name for s in run.stages_of("iam")]
    assert [r["stage"] for r in first] == names and not any(r["skipped"] for r in first)
    for a in ARTIFACTS:
        assert os.path.exists(os.path.join(runs_dir, a)), a
    assert len(os.listdir(os.path.join(runs_dir, "real_demo"))) == 128
    regen = os.path.join(runs_dir, "regen_ddim")
    made = [f for f in os.listdir(regen) if f.endswith(".png")] + os.listdir(
        os.path.join(regen, "rejected"))
    assert len(made) == 128  # --keep_rejected 1: every crop, accepted or not
    for k in EVALS:
        res = json.loads(open(os.path.join(runs_dir, f"eval_fid_{k}.json")).read())
        assert all(np.isfinite(v) for v in res.values() if isinstance(v, float)), res
    assert "ocr_exact_match" in json.loads(
        open(os.path.join(runs_dir, "eval_fid_filtered.json")).read())
    logged = [json.loads(l) for l in open(os.path.join(runs_dir, ".chains/iam/log.jsonl"))]
    assert [r["stage"] for r in logged] == names

    assert all(r["skipped"] for r in run.main(argv))
    os.remove(os.path.join(runs_dir, ".chains/iam/eval_filtered.done"))
    third = run.main(argv)
    assert [r["stage"] for r in third if not r["skipped"]] == ["eval_filtered"]

    # the untrained filter accepts (almost) none: stand in for a trained one
    # with half the ddim dump, and rerun the six stages that read it
    rej_dir = os.path.join(regen, "rejected")
    for f in sorted(f for f in os.listdir(rej_dir) if f.endswith(".png"))[::2]:
        os.rename(os.path.join(rej_dir, f), os.path.join(regen, f))
    rerun = ["subsets"] + [f"eval_{k}" for k in EVALS]
    for name in rerun:
        os.remove(os.path.join(runs_dir, f".chains/iam/{name}.done"))
    fourth = run.main(argv)
    assert [r["stage"] for r in fourth if not r["skipped"]] == rerun
    for d in SUBSETS:
        assert len(os.listdir(os.path.join(runs_dir, d))) > 1, d
    for k in EVALS:
        res = json.loads(open(os.path.join(runs_dir, f"eval_fid_{k}.json")).read())
        assert np.isfinite(res.get("fid_phosc", np.nan)), (k, res)


def test_chain_refuses_without_a_card_and_a_missing_codec(tmp_path, monkeypatch):
    """No CPU fallback: cuda without a card exits; the nor chains stop
    before their first stage naming the codec no script makes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        run.main(["iam", "--runs_dir", str(tmp_path)])
    for chain in ("nor", "nor_special"):
        with pytest.raises(SystemExit, match="vae_syn_v2"):
            run.main([chain, "--runs_dir", str(tmp_path), "--device", "cpu"])
    assert not os.path.exists(tmp_path / ".chains" / "nor")
    with pytest.raises(SystemExit, match="no stage"):
        run.main(["iam", "--runs_dir", str(tmp_path), "--device", "cpu", "--stages", "nope"])


def test_eval_vae_ckpt_reads_the_port_vae(tiny_chain, tmp_path):
    """``chains.eval_vae_ckpt`` on a port trainer's ``--save_dir``: the
    script's metrics keys, no step for a ``vae.pt``, the grid written."""
    from worddiffusion_tpu_torch.chains import eval_vae_ckpt
    from worddiffusion_tpu_torch.models.layers import init_weights_
    from worddiffusion_tpu_torch.models.vae import AutoencoderKL

    save = tmp_path / "vae_syn"
    save.mkdir()
    vae = init_weights_(AutoencoderKL(presets.get("iam").vae, with_encoder=True), seed=3)
    torch.save(vae.state_dict(), save / "vae.pt")
    metrics = eval_vae_ckpt.main(["--save_dir", str(save), "--preset", "iam", "--device", "cpu"])
    assert json.loads((save / "metrics.json").read_text()) == metrics
    assert sorted(metrics) == ["heldout_mse", "heldout_psnr_db", "steps"]
    assert metrics["steps"] is None and np.isfinite(metrics["heldout_psnr_db"])
    assert read_png(str(save / "recon_grid.png")).shape == (8 * 64, 2 * 256, 3)


def _jax_vae_tree(cfg, h, w, seed):
    """A random Flax VAE tree whose posterior is a point: the logvar half of
    ``quant_conv`` is clipped to -30 (std 3e-7), so a reconstruction is the
    decoded mean whatever the draw, and JAX's and the port's draws agree."""
    import jax

    from worddiffusion_tpu.models.vae import AutoencoderKL as JaxVAE

    shapes = jax.eval_shape(JaxVAE(cfg).init, jax.random.PRNGKey(0),
                            np.zeros((1, h, w, 3), np.float32), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    qc, c = tree["params"]["quant_conv"], cfg.latent_channels
    qc["kernel"][..., c:] = 0.0
    qc["bias"][c:] = -60.0
    return tree


def test_eval_vae_ckpt_matches_the_jax_script(tmp_path, monkeypatch):
    """``scripts/eval_vae_ckpt.py`` and ``chains.eval_vae_ckpt`` on one orbax
    ``<save_dir>/ckpt`` (steps 20 and 30, different weights): the same newest
    step and held-out MSE, and reconstruction grids a pixel level apart. The
    port's ``vae.pt`` of the same weights gives the same numbers; step 20's
    weights give an MSE the bound tells apart."""
    import importlib.util

    import orbax.checkpoint as ocp

    from worddiffusion_tpu.configs import presets as jpresets
    from worddiffusion_tpu.configs.config import DataConfig, Experiment, VAEConfig
    from worddiffusion_tpu_torch.chains import eval_vae_ckpt
    from worddiffusion_tpu_torch.models.convert import jax_vae_to_torch, state_dict_to_torch

    cfg = VAEConfig(base_channels=32, channel_mult=(1, 1, 1, 1), num_res_blocks=1,
                    dtype="float32")
    jexp = Experiment(vae=cfg, data=DataConfig(img_height=32, img_width=128))
    monkeypatch.setitem(jpresets.PRESETS, "tiny_eval", lambda: jexp)
    monkeypatch.setitem(presets.PRESETS, "tiny_eval", lambda: port_cfg(jexp))
    trees = {step: _jax_vae_tree(cfg, 32, 128, step) for step in (20, 30)}
    save = tmp_path / "vae_syn"
    mgr = ocp.CheckpointManager(str(save / "ckpt"),
                                options=ocp.CheckpointManagerOptions(max_to_keep=2, create=True))
    for step, tree in trees.items():
        mgr.save(step, args=ocp.args.StandardSave(tree))
    mgr.wait_until_finished()
    mgr.close()

    spec = importlib.util.spec_from_file_location(
        "jax_eval_vae_ckpt", os.path.join(ROOT, "scripts", "eval_vae_ckpt.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["eval_vae_ckpt.py", "--save_dir", str(save),
                                      "--preset", "tiny_eval"])
    script.main()
    want = json.loads((save / "metrics.json").read_text())
    want_grid = read_png(str(save / "recon_grid.png")).astype(np.int16)

    port_argv = ["--preset", "tiny_eval", "--device", "cpu", "--save_dir"]
    got = eval_vae_ckpt.main(port_argv + [str(save)])
    assert json.loads((save / "metrics.json").read_text()) == got
    assert sorted(got) == sorted(want) == ["heldout_mse", "heldout_psnr_db", "steps"]
    assert got["steps"] == want["steps"] == 30
    np.testing.assert_allclose(got["heldout_mse"], want["heldout_mse"], rtol=1e-4)
    np.testing.assert_allclose(got["heldout_psnr_db"], want["heldout_psnr_db"], rtol=1e-4)
    grid = read_png(str(save / "recon_grid.png")).astype(np.int16)
    assert grid.shape == want_grid.shape == (8 * 32, 2 * 128, 3)
    assert np.abs(grid - want_grid).max() <= 1

    mse = {}
    for step, tree in trees.items():
        d = tmp_path / f"port_{step}"
        d.mkdir()
        torch.save(state_dict_to_torch(jax_vae_to_torch(tree, port_cfg(cfg))), d / "vae.pt")
        m = eval_vae_ckpt.main(port_argv + [str(d)])
        assert m["steps"] is None
        mse[step] = m["heldout_mse"]
    assert mse[30] == got["heldout_mse"]
    assert abs(mse[20] - want["heldout_mse"]) > 100 * 1e-4 * want["heldout_mse"]
