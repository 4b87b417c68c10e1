"""The reference UNet checkpoints without the JAX package: the port's
``models.convert.reference_unet_to_port`` / ``port_unet_to_reference``
against JAX's ``convert_reference_unet`` / ``export_reference_unet``, the
export CLI, and the checkpoint-directory flags of the regeneration,
sampling and evaluation CLIs.

A reference-layout state dict is made from seeded JAX parameters by JAX's
own exporter, then given what the reference's checkpoints carry beyond it:
the research ``UNetModel``'s dead ``to_kv`` / ``attnc`` / ``norm1`` tensors,
the ``--attentionMaps`` ``middle_block1`` layout, the ``{"state_dict": ...}``
wrapper and the ``CTCtopC`` aux head with eval-mode BatchNorm (random
running statistics). fp32 forwards agree within the UNet parity's 1e-4
relative + 1e-5 absolute; the converters' tensors agree bitwise.
"""

import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from worddiffusion_tpu.configs import presets as jpresets
from worddiffusion_tpu.configs.config import DataConfig, Experiment, UNetConfig
from worddiffusion_tpu.models import convert as jconvert
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from test_torch_copies import port_cfg
from test_torch_orbax import tiny_presets, write_jax_run  # noqa: F401 (a fixture)
from test_torch_train import tiny_exp
from test_torch_vae_ocr import PORT_VAE_CFG, VAE_CFG
from worddiffusion_tpu_torch.cli import evaluate as eval_cli
from worddiffusion_tpu_torch.cli import export_reference as export_cli
from worddiffusion_tpu_torch.cli import regenerate as regen_cli
from worddiffusion_tpu_torch.cli import sample as sample_cli
from worddiffusion_tpu_torch.configs import presets
from worddiffusion_tpu_torch.data.alphabets import OCR_ENG
from worddiffusion_tpu_torch.models import convert
from worddiffusion_tpu_torch.models.layers import init_weights_
from worddiffusion_tpu_torch.models.ocr import CTCRecognizer
from worddiffusion_tpu_torch.models.unet import UNet
from worddiffusion_tpu_torch.models.vae import AutoencoderKL
from worddiffusion_tpu_torch.train.checkpoint import CheckpointManager
from worddiffusion_tpu_torch.train.state import TrainState, make_optimizer

torch.set_num_threads(1)

B = 2
IAM = dataclasses.replace(jpresets.get("iam").unet, model_channels=32, context_dim=32,
                          dtype="float32")
CFGS = {
    # the flagship at a narrow width
    "iam": IAM,
    # more levels and res-blocks: the block indices come from the config
    "deep": dataclasses.replace(IAM, channel_mult=(1, 2), num_res_blocks=2,
                                attention_resolutions=(1, 2), num_heads=2),
    # the WordStylist layout, whose self-attention reads norm1
    "wordstylist": dataclasses.replace(IAM, attn1_cross=False),
    # the CTCtopC aux head, BatchNorm folded into the convs
    "ocr_head": dataclasses.replace(IAM, ocr_head=True, ocr_norm="none", ocr_hidden=32,
                                    ocr_layers=2, ocr_classes=20),
}


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 8, 32, 4)).astype(np.float32), np.array([5, 50], np.int32),
            rng.integers(0, cfg.vocab_size - 1, (B, cfg.max_seq_len)).astype(np.int32),
            np.array([0, 3], np.int32))


@functools.lru_cache(maxsize=None)
def _params(cfg, seed=3):
    shapes = jax.eval_shape(JaxUNet(cfg).init, jax.random.PRNGKey(0), *_inputs(cfg))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def _jax_apply(cfg):
    return jax.jit(JaxUNet(cfg).apply)


def reference_sd(cfg, middle_block1=False, seed=7) -> dict:
    """A reference checkpoint's state dict (numpy) of ``_params(cfg)``: JAX's
    export, the research UNet's dead tensors and, with ``ocr_head``, the
    CTCtopC head with eval-mode BatchNorm."""
    params = _params(cfg)
    sd = jconvert.export_reference_unet(params, cfg, middle_block1=middle_block1)
    rng = np.random.default_rng(seed)
    for k in [k for k in sd if k.endswith(".attn2.to_q.weight")]:
        tb, d = k[:-len(".attn2.to_q.weight")], sd[k].shape[1]
        sd[tb + ".attn1.to_kv.weight"] = rng.standard_normal((2 * d, d)).astype(np.float32)
        sd[tb + ".attnc.to_q.weight"] = rng.standard_normal((d, d)).astype(np.float32)
        sd[tb + ".attnc.to_out.0.bias"] = rng.standard_normal(d).astype(np.float32)
        if cfg.attn1_cross:  # built, never run
            sd[tb + ".norm1.weight"] = rng.standard_normal(d).astype(np.float32)
            sd[tb + ".norm1.bias"] = rng.standard_normal(d).astype(np.float32)
    if cfg.ocr_head:
        sd.update(convert.jax_unet_extras_to_torch(params, cfg))
        for name in ["auxhead.temporal_i"] + [f"auxhead.temporal_m.{i}"
                                              for i in range(cfg.ocr_layers)]:
            c = sd[name + ".0.weight"].shape[0]
            sd[name + ".1.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            sd[name + ".1.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            sd[name + ".1.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            sd[name + ".1.running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            sd[name + ".1.num_batches_tracked"] = np.array(1000, np.int64)
    return sd


def _to_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _port_forward(cfg, port_sd, inp):
    m = UNet(port_cfg(cfg))
    m.load_state_dict(convert.state_dict_to_torch(port_sd), strict=True)
    with torch.no_grad():
        out = m.eval()(*(torch.from_numpy(a).long() if a.dtype == np.int32 else
                         torch.from_numpy(a) for a in inp))
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name,middle_block1,wrapped", [
    ("iam", False, True), ("iam", True, False), ("deep", False, False), ("deep", True, True),
    ("wordstylist", True, False), ("ocr_head", True, True),
])
def test_reference_checkpoint_forward_matches_jax(name, middle_block1, wrapped, tmp_path):
    """The port's UNet on ``reference_unet_to_port`` of a reference
    checkpoint against JAX's UNet on ``convert_reference_unet`` of the same
    file (through each package's ``load_torch_checkpoint`` where it is
    wrapped): eps, and the CTC logits with the head."""
    cfg = CFGS[name]
    sd = reference_sd(cfg, middle_block1)
    path = tmp_path / "ema_ckpt.pt"
    torch.save({"state_dict": _to_torch(sd)} if wrapped else _to_torch(sd), path)
    jsd = jconvert.load_torch_checkpoint(str(path)) if wrapped else sd
    inp = _inputs(cfg)
    want = _jax_apply(cfg)(jconvert.convert_reference_unet(jsd, cfg), *inp)
    want = want if isinstance(want, tuple) else (want,)
    port_sd = convert.reference_unet_to_port(convert.load_torch_checkpoint(str(path)),
                                             port_cfg(cfg))
    got = _port_forward(cfg, port_sd, inp)
    assert len(got) == len(want) == (2 if cfg.ocr_head else 1)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-2
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * max(1, np.abs(w).max()))
    # the wrapper is unwrapped by the converter too, and the dead tensors
    # and buffers are what is left unread
    assert convert.reference_unet_to_port({"state_dict": sd}, port_cfg(cfg)).keys() == \
        port_sd.keys() == UNet(port_cfg(cfg)).state_dict().keys()


@pytest.mark.parametrize("name,drop", [
    ("iam", "input_blocks.1.1.transformer_blocks.0.attn2.to_k.weight"),
    ("deep", "output_blocks.4.0.skip_connection.bias"),
    ("iam", "middle_block1.1.0.out_layers.3.bias"),
    ("ocr_head", "auxhead.temporal_m.1.1.running_var"),
])
def test_missing_key_raises_as_jax(name, drop):
    """A tensor the UNet needs and the checkpoint lacks: a KeyError naming
    it in both packages."""
    cfg = CFGS[name]
    sd = reference_sd(cfg, middle_block1=drop.startswith("middle_block1"))
    del sd[drop]
    with pytest.raises(KeyError) as want:
        jconvert.convert_reference_unet(sd, cfg)
    with pytest.raises(KeyError) as got:
        convert.reference_unet_to_port(sd, port_cfg(cfg))
    assert got.value.args == want.value.args == (drop,)


def test_batchnorm_head_needs_ocr_norm_none_as_jax():
    cfg = dataclasses.replace(CFGS["ocr_head"], ocr_norm="group")
    sd = reference_sd(CFGS["ocr_head"])
    with pytest.raises(ValueError) as want:
        jconvert.convert_reference_unet(sd, cfg)
    with pytest.raises(ValueError) as got:
        convert.reference_unet_to_port(sd, port_cfg(cfg))
    assert str(got.value) == str(want.value)


def test_port_group_norm_head_and_glyphs_pass_through():
    """The port's own checkpoints: a GroupNorm aux head (``ocr_norm``
    "group", as its trainer saves it) and the glyph encoder, which JAX's
    converter does not carry, are taken under their keys."""
    cfg = dataclasses.replace(IAM, ocr_head=True, ocr_hidden=32, ocr_layers=1, ocr_classes=20,
                              use_char_images=True)
    m = init_weights_(UNet(port_cfg(cfg)), seed=0)
    sd = m.state_dict()
    got = convert.reference_unet_to_port(sd, port_cfg(cfg))
    assert got.keys() == sd.keys() and all(np.array_equal(got[k], sd[k].numpy()) for k in sd)
    no_head = convert.reference_unet_to_port(sd, port_cfg(dataclasses.replace(
        cfg, ocr_head=False)))  # sampling presets: the head left unread
    assert not any(k.startswith("auxhead.") for k in no_head)


@pytest.mark.parametrize("name", ["iam", "deep", "wordstylist"])
@pytest.mark.parametrize("template,middle_block1", [(False, False), (True, False),
                                                    (False, True), (True, True)])
def test_exporter_bitwise_as_jax(name, template, middle_block1):
    """``port_unet_to_reference`` of the port's UNet against JAX's
    ``export_reference_unet`` of the same parameters: the same keys in the
    same order, every tensor bitwise, the template's extras merged under."""
    cfg = CFGS[name]
    params = _params(cfg)
    tmpl = reference_sd(cfg, seed=11) if template else None
    want = jconvert.export_reference_unet(params, cfg, template=tmpl,
                                          middle_block1=middle_block1)
    port_sd = convert.reference_unet_to_port(jconvert.export_reference_unet(params, cfg),
                                             port_cfg(cfg))
    m = UNet(port_cfg(cfg))
    m.load_state_dict(convert.state_dict_to_torch(port_sd), strict=True)
    got = convert.port_unet_to_reference(m.state_dict(), port_cfg(cfg),
                                         template=_to_torch(tmpl) if template else None,
                                         middle_block1=middle_block1)
    assert list(got) == list(want)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# -- checkpoint directories --------------------------------------------------------
TINY = tiny_exp().unet


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A tiny preset and a port training run's directory: ``ckpt/`` with
    two steps (EMA and trained weights differ), writers_dict_train.json
    beside it, ``vae/vae.pt`` and ``ocr/ocr.pt`` as the side trainers write
    them, and a gt file."""
    exp = port_cfg(Experiment(vae=VAE_CFG, unet=TINY, data=DataConfig(max_chars=10)))
    monkeypatch.setitem(presets.PRESETS, "tiny_ckpt", lambda: exp)
    model = init_weights_(UNet(exp.unet), seed=1)
    state = TrainState.create(model, make_optimizer(model.parameters(), 1e-3))
    mgr = CheckpointManager(str(tmp_path / "run" / "ckpt"))
    for step in (4, 8):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(0.01)
            for p in state.ema.parameters():
                p.sub_(0.02)
        state.step = step
        mgr.save(step, state)
    (tmp_path / "run" / "writers_dict_train.json").write_text(json.dumps({"w07": 5, "w09": 2}))
    (tmp_path / "vae").mkdir()
    vae = init_weights_(AutoencoderKL(PORT_VAE_CFG, with_encoder=True), seed=11)
    torch.save(vae.state_dict(), tmp_path / "vae" / "vae.pt")
    (tmp_path / "ocr").mkdir()
    ocr = init_weights_(CTCRecognizer(num_classes=len(OCR_ENG)), seed=5)
    torch.save(ocr.state_dict(), tmp_path / "ocr" / "ocr.pt")
    gt = tmp_path / "words.filter27"
    gt.write_text("w07,a01-000u-00 the\nw09,a01-001u-00 of\n")
    return dict(tmp=tmp_path, ckpt=str(tmp_path / "run" / "ckpt"), state=state, vae=vae,
                ocr=ocr, gt=str(gt))


def _same(module, sd) -> bool:
    got = module.state_dict()
    return got.keys() == sd.keys() and all(torch.equal(got[k], sd[k].cpu()) for k in sd)


@pytest.mark.parametrize("use_ema", [1, 0])
def test_regenerate_reads_checkpoint_dirs(run_dir, use_ema):
    """regenerate --ckpt_dir [--use_ema 0] --vae_ckpt --ocr_ckpt: the newest
    step's EMA (or trained) weights, vae.pt's decode half, ocr.pt, and the
    training writers dict found beside the checkpoint directory."""
    r = run_dir
    regen, samples = regen_cli.build(regen_cli.build_parser().parse_args([
        "--preset", "tiny_ckpt", "--gt_file", r["gt"], "--ckpt_dir", r["ckpt"], "--use_ema",
        str(use_ema), "--vae_ckpt", str(r["tmp"] / "vae"), "--ocr_ckpt", str(r["tmp"] / "ocr"),
        "--dump_path", str(r["tmp"] / "regen"), "--device", "cpu"]))
    want = (r["state"].ema if use_ema else r["state"].model).state_dict()
    assert _same(regen.sampler.model, want)
    vae_sd = {k: v for k, v in r["vae"].state_dict().items()
              if not k.startswith(("encoder.", "quant_conv."))}
    assert _same(regen.sampler.vae, vae_sd)
    assert _same(regen.sampler.ocr_apply, r["ocr"].state_dict())
    assert [regen.writer_lookup(s.writer) for s in samples] == [5, 2]


def test_sample_reads_checkpoint_dirs(run_dir):
    """sample --ckpt_dir --use_ema 0 --vae_ckpt: the trained weights and the
    VAE, and the writers dict beside the directory maps --writer to its
    raw id."""
    r = run_dir
    args = sample_cli.build_parser().parse_args([
        "--preset", "tiny_ckpt", "--words", "the", "--writer", "2", "--ckpt_dir", r["ckpt"],
        "--use_ema", "0", "--vae_ckpt", str(r["tmp"] / "vae"), "--device", "cpu"])
    sampler, pairs, *_ = sample_cli.build(args)
    assert _same(sampler.model, r["state"].model.state_dict())
    assert _same(sampler.vae, {k: v for k, v in r["vae"].state_dict().items()
                               if not k.startswith(("encoder.", "quant_conv."))})
    assert pairs == [("the", 2, "w09")]


def test_evaluate_ocr_ckpt_is_ocr_pt(run_dir):
    r = run_dir
    d = r["tmp"] / "imgs"
    d.mkdir()
    from worddiffusion_tpu_torch.utils.images import encode_png

    rng = np.random.default_rng(0)
    for i, w in enumerate(("the", "of")):
        (d / f"{i:05d}_0_{w}.png").write_bytes(
            encode_png(rng.integers(0, 255, (64, 256, 3), dtype=np.uint8)))
    argv = ["--real_dir", str(d), "--fake_dir", str(d), "--device", "cpu"]
    a = eval_cli.main(argv + ["--ocr_ckpt", str(r["tmp"] / "ocr")])
    b = eval_cli.main(argv + ["--ocr_pt", str(r["tmp"] / "ocr" / "ocr.pt")])
    assert "ocr_exact_match" in a and a == b


@pytest.mark.parametrize("use_ema,middle_block1,template,step", [
    (1, 0, False, -1), (0, 0, False, -1), (1, 1, True, -1), (0, 1, False, 4)])
def test_export_cli_round_trips_bitwise(run_dir, use_ema, middle_block1, template, step):
    """export_reference of a training checkpoint, read back through
    ``reference_unet_to_port``: the checkpoint's EMA (or trained) tensors
    bitwise; JAX's converter reads the same file to the same values."""
    r = run_dir
    out = r["tmp"] / "export.pt"
    argv = ["--preset", "tiny_ckpt", "--ckpt_dir", r["ckpt"], "--out", str(out),
            "--use_ema", str(use_ema), "--middle_block1", str(middle_block1), "--step", str(step)]
    if template:
        # an original checkpoint of the same layout
        tmpl = reference_sd(TINY, middle_block1=bool(middle_block1), seed=2)
        torch.save({"state_dict": _to_torch(tmpl)}, r["tmp"] / "t.pt")
        argv += ["--template", str(r["tmp"] / "t.pt")]
    export_cli.main(argv)
    exported = torch.load(out, weights_only=True)
    assert any(k.startswith("middle_block1.") for k in exported) == bool(middle_block1)
    assert any(".to_kv." in k for k in exported) == template
    ck = torch.load(os.path.join(r["ckpt"], str(8 if step < 0 else step), "state.pt"),
                    weights_only=True)
    want = ck["ema" if use_ema else "model"]
    back = convert.reference_unet_to_port(exported, port_cfg(TINY))
    assert back.keys() == want.keys()
    assert all(np.array_equal(back[k], want[k].numpy()) for k in want)
    jparams = jconvert.convert_reference_unet({k: v.numpy() for k, v in exported.items()}, TINY)
    again = jconvert.export_reference_unet(jparams, TINY)
    assert all(np.array_equal(again[k], want[k].numpy()) for k in again)


@pytest.fixture(scope="module")
def orbax_dir(tmp_path_factory):
    """The JAX CLIs' orbax directories (``test_torch_orbax.write_jax_run``: the
    Trainer's TrainState at steps 4 and 8 with a writers dict beside it, the
    VAE's and the OCR's managers) and the same weights in the port's files,
    at the widths of the preset ``tiny_presets`` registers."""
    return write_jax_run(tmp_path_factory.mktemp("orbax"))


def test_orbax_files_are_zstd(orbax_dir):
    """orbax's OCDBT manifests and nodes hold zstd frames; the port checks
    each one's crc32c and decodes its body as zstandard does (each manifest
    and each node that starts a data file)."""
    zstandard = pytest.importorskip("zstandard")
    from worddiffusion_tpu_torch.utils import ocdbt

    found = 0
    for d, _, names in os.walk(orbax_dir["root"]):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                raw = f.read()
            magic = int.from_bytes(raw[:4], "big")
            if magic not in (ocdbt.MANIFEST_MAGIC, ocdbt.NODE_MAGIC):
                continue
            # a data file may hold a node and then values or more nodes: the
            # node at its start, by its length field
            raw = raw[:int.from_bytes(raw[4:12], "little")]
            assert raw[14:18] == b"\x28\xb5\x2f\xfd", path
            want = zstandard.ZstdDecompressor().decompressobj().decompress(raw[14:-4])
            assert ocdbt.decode_file(raw, magic, path) == want, path
            found += 1
    assert found >= 8


def _decode_half(sd):
    return {k: v for k, v in sd.items() if not k.startswith(("encoder.", "quant_conv."))}


@pytest.mark.parametrize("cli,flag", [
    ("regenerate", "--ckpt_dir"), ("regenerate", "--vae_ckpt"), ("regenerate", "--ocr_ckpt"),
    ("sample", "--ckpt_dir"), ("sample", "--vae_ckpt"), ("evaluate", "--ocr_ckpt"),
    ("export_reference", "--ckpt_dir"),
])
def test_orbax_dirs_refused(run_dir, orbax_dir, tiny_presets, cli, flag):
    """Each flag that once refused the JAX package's orbax directories now
    reads them, the manager's directory and its newest step alike: the
    modules the CLI builds hold the same weights as from the port's files
    (the UNet's EMA, the VAE's decode half, the OCR), evaluate's numbers are
    --ocr_pt's, and export_reference writes what JAX's export_torch computes
    from the same directory (orbax's restore, then export_reference_unet),
    bitwise."""
    ocp = pytest.importorskip("orbax.checkpoint")
    r, o, preset = run_dir, orbax_dir, tiny_presets
    port = {"--ckpt_dir": torch.load(os.path.join(o["port"], "ema_unet_8.pt"), weights_only=True),
            "--vae_ckpt": _decode_half(torch.load(os.path.join(o["port"], "vae.pt"),
                                                  weights_only=True)),
            "--ocr_ckpt": torch.load(os.path.join(o["port"], "ocr.pt"), weights_only=True)}
    manager = {"--ckpt_dir": o["ckpt"], "--vae_ckpt": o["vae_ckpt"], "--ocr_ckpt": o["ocr_ckpt"]}
    newest = {"--ckpt_dir": "8", "--vae_ckpt": "30", "--ocr_ckpt": "30"}
    evaluated = {}
    for path in (manager[flag], os.path.join(manager[flag], newest[flag])):
        if cli == "regenerate":
            regen, samples = regen_cli.build(regen_cli.build_parser().parse_args([
                "--preset", preset, "--gt_file", r["gt"], "--device", "cpu", flag, path]))
            module = {"--ckpt_dir": regen.sampler.model, "--vae_ckpt": regen.sampler.vae,
                      "--ocr_ckpt": regen.sampler.ocr_apply}[flag]
            assert _same(module, port[flag])
            if flag == "--ckpt_dir" and path == manager[flag]:  # the dict beside it
                assert [regen.writer_lookup(s.writer) for s in samples] == [5, 2]
        elif cli == "sample":
            sampler, pairs, *_ = sample_cli.build(sample_cli.build_parser().parse_args([
                "--preset", preset, "--words", "the", "--writer", "2", "--device", "cpu",
                flag, path]))
            assert _same(sampler.model if flag == "--ckpt_dir" else sampler.vae, port[flag])
            if flag == "--ckpt_dir" and path == manager[flag]:
                assert pairs == [("the", 2, "w09")]
        elif cli == "evaluate":
            d = r["tmp"] / "imgs"
            if not d.exists():
                d.mkdir()
                from worddiffusion_tpu_torch.utils.images import encode_png

                rng = np.random.default_rng(0)
                for i, w in enumerate(("the", "of")):
                    (d / f"{i:05d}_0_{w}.png").write_bytes(
                        encode_png(rng.integers(0, 255, (64, 256, 3), dtype=np.uint8)))
            argv = ["--real_dir", str(d), "--fake_dir", str(d), "--device", "cpu"]
            if "port" not in evaluated:
                evaluated["port"] = eval_cli.main(argv + ["--ocr_pt",
                                                          os.path.join(o["port"], "ocr.pt")])
            got = eval_cli.main(argv + [flag, path])
            assert "ocr_exact_match" in got and got == evaluated["port"]
        else:
            if "jax" not in evaluated:  # export_torch: orbax's restore, then the exporter
                mgr = ocp.CheckpointManager(o["ckpt"])
                restored = mgr.restore(8, args=ocp.args.StandardRestore())
                mgr.close()
                evaluated["jax"] = jconvert.export_reference_unet(restored["ema_params"], TINY)
            out = r["tmp"] / "x.pt"
            export_cli.main(["--preset", preset, "--out", str(out), flag, path])
            got, jsd = torch.load(out, weights_only=True), evaluated["jax"]
            assert got.keys() == jsd.keys()
            assert all(got[k].numpy().tobytes() == np.asarray(jsd[k]).tobytes() for k in jsd)


def test_export_cli_takes_the_jax_options():
    """Every option of JAX's export_torch parser, and --step."""
    import argparse
    from unittest import mock

    from worddiffusion_tpu.cli import export_torch as jexport_cli

    class Parsed(Exception):
        pass

    def grab(self, *a, **k):
        raise Parsed(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(Parsed) as got:
            jexport_cli.main([])
    jax_opts = {o for a in got.value.args[0]._actions for o in a.option_strings}
    port_opts = {o for a in export_cli.build_parser()._actions for o in a.option_strings}
    assert port_opts - jax_opts == {"--step"}
