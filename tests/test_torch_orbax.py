"""The JAX package's orbax checkpoints read without JAX: ``utils/ocdbt.py``,
``train/orbax.py``, ``models.convert.jax_unet_to_torch`` and the CLIs and
the Trainer that read them, against orbax, TensorStore and the JAX package
on the CPU.

- ``read_orbax`` is bitwise orbax's own ``StandardRestore`` on
  ``TrainState``s the JAX package's ``CheckpointManager`` wrote (fp32 and
  bfloat16, 0-d leaves, zero moments, two steps and a leftover temporary
  directory, a ``MeshConfig(model=2)`` write in chunks of a shard at most);
  zarr arrays with missing chunks and partial edge chunks, and an
  OCDBT b-tree with interior nodes (written by TensorStore directly, at a
  small node size), are read bitwise as TensorStore reads them.
- ``jax_unet_to_torch``: key for key bitwise JAX's ``export_reference_unet``
  + ``jax_unet_extras_to_torch``, every Flax parameter mapped, for every
  preset variant the port has (their forwards against the JAX UNet are the
  UNet parity tests', which load through it).
- The CLIs on orbax directories give what the same weights in the port's
  files give (regeneration's PNGs bitwise; the latent cache; the train
  CLI's VAE).
- Resuming a JAX run: the JAX Trainer takes 2 steps; the port's Trainer
  restores them (parameters, EMA, moments bitwise) and takes step 3 with
  JAX's draws; it agrees with JAX's step 3 within the bounds of
  ``test_torch_train.py::test_train_step_matches_jax``, carried to Adam's
  restored moments. ``cli.train --loadPrev 1`` continues the run.
- The committed check set (``worddiffusion_tpu_torch/train/orbax_check.npz``,
  what the card's run reads) decodes to its expected arrays, and so does a
  set written anew. ``python tests/test_torch_orbax.py`` rewrites it.
"""

import copy
import dataclasses
import functools
import json
import os
import shutil
import sys

# run as a script (the check set's generator): the repo and this directory
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from worddiffusion_tpu.configs import presets as jpresets  # noqa: E402
from worddiffusion_tpu.configs.config import (  # noqa: E402
    DataConfig, Experiment, UNetConfig, VAEConfig,
)
from worddiffusion_tpu.models.convert import export_reference_unet  # noqa: E402
from worddiffusion_tpu.models.ocr import CTCRecognizer as JaxOCR  # noqa: E402
from worddiffusion_tpu.models.unet import UNet as JaxUNet  # noqa: E402
from worddiffusion_tpu.models.vae import AutoencoderKL as JaxVAE  # noqa: E402
from worddiffusion_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints  # noqa: E402
from worddiffusion_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from worddiffusion_tpu.train.state import make_optimizer as jax_optimizer  # noqa: E402

from test_torch_copies import port_cfg  # noqa: E402
from test_torch_train import CFG, tiny_exp  # noqa: E402
from worddiffusion_tpu_torch.data.alphabets import OCR_ENG  # noqa: E402
from worddiffusion_tpu_torch.models.convert import (  # noqa: E402
    jax_ocr_to_torch, jax_unet_extras_to_torch, jax_unet_to_torch, jax_vae_to_torch,
    state_dict_to_torch,
)
from worddiffusion_tpu_torch.train import orbax_check  # noqa: E402
from worddiffusion_tpu_torch.train.orbax import orbax_steps, read_orbax, read_zarr  # noqa: E402
from worddiffusion_tpu_torch.utils.ocdbt import OcdbtStore  # noqa: E402

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")

torch.set_num_threads(1)


# -- trees -------------------------------------------------------------------------
def _unet_init_args(cfg, b=2, hw=(8, 32)):
    lat = np.zeros((b, *hw, cfg.in_channels), np.float32)
    return (lat, np.zeros((b,), np.int32), np.zeros((b, 10), np.int32),
            np.zeros((b,), np.int32))


@functools.lru_cache(maxsize=None)
def unet_shapes(cfg):
    """The Flax UNet's parameter shapes (traced once a config: 4 s)."""
    return jax.eval_shape(lambda r, *a: JaxUNet(cfg).init(r, *a), jax.random.PRNGKey(0),
                          *_unet_init_args(cfg))


def random_tree(shapes, seed, scale=0.05, square=False):
    rng = np.random.default_rng(seed)

    def leaf(s):
        v = (scale * rng.standard_normal(s.shape)).astype(np.float32)
        return v * v if square else v

    return jax.tree_util.tree_map(leaf, shapes)


def adam_state(params, mu, nu, count):
    """optax.adamw's state with the given moments: (ScaleByAdamState,
    EmptyState, EmptyState)."""
    st = jax_optimizer(1e-4).init(params)
    return (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu),) + tuple(st[1:])


def restored_leaves(step_dir) -> dict:
    """orbax's own StandardRestore of ``step_dir``, flattened as
    ``orbax_check.flatten`` flattens ``read_orbax``."""
    parent, step = os.path.split(os.path.abspath(step_dir))
    mgr = ocp.CheckpointManager(parent)
    tree = mgr.restore(int(step), args=ocp.args.StandardRestore())
    mgr.close()
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None))))
                       for k in path)
        v = np.asarray(v)
        out[key] = v.view(np.uint16) if v.dtype.name == "bfloat16" else v
    return out


def assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), k


# -- read_orbax against StandardRestore ---------------------------------------------
NARROW = UNetConfig(model_channels=32, context_dim=32, num_heads=2, vocab_size=54,
                    num_writers=8, max_seq_len=10, dtype="float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_read_orbax_matches_standard_restore(tmp_path, dtype):
    """Two steps of a narrow UNet's TrainState (the first with zero moments
    and a zero-initialised output conv, the second random), a leftover
    temporary directory; every leaf, the 0-d step and count too."""
    shapes = unet_shapes(NARROW)
    mgr = JaxCheckpoints(str(tmp_path / "ckpt"))
    cast = (lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t))
    p1 = cast(random_tree(shapes, 1))
    p1["params"]["out_conv"]["Conv_0"]["kernel"] = jnp.zeros_like(
        p1["params"]["out_conv"]["Conv_0"]["kernel"])
    mgr.save(1, JaxTrainState.create(p1, jax_optimizer(1e-4)))
    p2 = cast(random_tree(shapes, 2))
    state = JaxTrainState(step=jnp.int32(2), params=p2, ema_params=cast(random_tree(shapes, 3)),
                          opt_state=adam_state(p2, cast(random_tree(shapes, 4)),
                                               cast(random_tree(shapes, 5, square=True)), 2))
    mgr.save(2, state)
    mgr.close()
    os.makedirs(tmp_path / "ckpt" / "3.orbax-checkpoint-tmp-1700000000" / "default")
    assert orbax_steps(str(tmp_path / "ckpt")) == [1, 2]
    got = {step: orbax_check.flatten(read_orbax(str(tmp_path / "ckpt" / str(step))))
           for step in (1, 2)}
    for step in (1, 2):
        assert_bitwise(got[step], restored_leaves(tmp_path / "ckpt" / str(step)))
    assert int(read_orbax(str(tmp_path / "ckpt"), "step")) == 2  # the newest
    ema = orbax_check.flatten(read_orbax(str(tmp_path / "ckpt"), "ema_params"), "ema_params.")
    assert_bitwise(ema, {k: v for k, v in got[2].items() if k.startswith("ema_params.")})


def test_read_orbax_sharded_write(tmp_path):
    """A TrainState placed on a MeshConfig(data=4, model=2) mesh of forced
    CPU devices is written in chunks no larger than a shard; read back
    whole."""
    from worddiffusion_tpu.configs.config import MeshConfig
    from worddiffusion_tpu.parallel.mesh import make_mesh, param_sharding

    mesh = make_mesh(MeshConfig(data=4, model=2))
    params = random_tree(unet_shapes(NARROW), 6)
    params = jax.device_put(params, param_sharding(params, mesh))
    state = JaxTrainState.create(params, jax_optimizer(1e-4))
    mgr = JaxCheckpoints(str(tmp_path / "ckpt"))
    mgr.save(5, state)
    mgr.close()
    store = OcdbtStore(str(tmp_path / "ckpt" / "5" / "default"))
    metas = [json.loads(store.read(k)) for k in store.keys() if k.endswith("/.zarray")]
    assert sum(m["chunks"] != m["shape"] for m in metas) >= 20  # the model axis' weights
    got = orbax_check.flatten(read_orbax(str(tmp_path / "ckpt" / "5")))
    assert_bitwise(got, restored_leaves(tmp_path / "ckpt" / "5"))


def test_zarr_missing_chunks_and_edges(tmp_path):
    """zarr v2 arrays in an OCDBT store, written by TensorStore as orbax
    configures it (zstd, C order): chunks left out where they equal the fill
    value (0 and 1.5, or no fill value), partial edge chunks; a layout orbax
    does not write (Fortran order) is refused by name."""
    rng = np.random.default_rng(0)
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/kv/"}
    want = {}
    for i, fill in enumerate([0.0, 1.5, None, "F"]):
        a = rng.standard_normal((7, 10)).astype(np.float32)
        order = "F" if fill == "F" else "C"
        fill = None if fill == "F" else fill
        a[:3, :4] = 0.0 if fill is None else fill  # one chunk all fill value
        meta = {"dtype": "<f4", "shape": [7, 10], "chunks": [3, 4], "order": order,
                "compressor": {"id": "zstd", "level": 1}, "fill_value": fill}
        arr = ts.open({"driver": "zarr", "kvstore": {**base, "path": f"a{i}/"},
                       "metadata": meta, "store_data_equal_to_fill_value": False},
                      create=True).result()
        arr[:, :8].write(a[:, :8]).result()  # the last chunk column is never written
        a[:, 8:] = 0.0 if fill is None else fill
        want[f"a{i}"] = a
    store = OcdbtStore(str(tmp_path / "kv"))
    assert "a0/0.0" not in store and "a1/0.0" not in store and "a0/0.2" not in store
    for name in ("a0", "a1", "a2"):
        got = read_zarr(store, name)
        assert got.dtype == np.float32 and got.tobytes() == want[name].tobytes(), name
    with pytest.raises(ValueError, match="only what orbax writes"):
        read_zarr(store, "a3")


def test_ocdbt_btree_with_interior_nodes(tmp_path):
    """A TensorStore OCDBT store at a 2 kB node size, so its b-tree has
    interior nodes (two levels above the leaves); every key and value, inline
    and indirect, as TensorStore lists and reads them. At the default node
    size (100 MB decoded, as orbax writes) the full-width iam TrainState's
    4 trees x about 300 arrays x 2 keys fit one leaf."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/kv/",
            "config": {"max_decoded_node_bytes": 2000, "max_inline_value_bytes": 100}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    with ts.Transaction() as txn:
        for i in range(1500):
            key = f"params.block_{i % 37}.w{i:05d}/{'.zarray' if i % 2 else '0.0'}"
            kv.with_transaction(txn)[key] = rng.integers(0, 256, int(rng.integers(1, 400))) \
                .astype(np.uint8).tobytes()
    store = OcdbtStore(str(tmp_path / "kv"))
    assert store.height >= 2
    keys = [k.decode() for k in kv.list().result()]
    assert store.keys() == sorted(keys)
    for k in keys:
        assert store.read(k) == kv.read(k).result().value, k


# -- jax_unet_to_torch --------------------------------------------------------------
IAM = dataclasses.replace(jpresets.get("iam").unet, model_channels=32, context_dim=32,
                          dtype="float32")
CONVERT_VARIANTS = {
    "iam": ({}, {}),
    "iam_phosc": (dict(dataclasses.asdict(jpresets.get("iam_phosc").unet),
                       model_channels=32, context_dim=32, dtype="float32"), "phosc"),
    "fold": (dict(attn_fold_context=True), {}),
    "pixel": (dict(in_channels=3, out_channels=3), {}),
    "film_split_skip": (dict(use_scale_shift_norm=True, split_skip_conv=True), {}),
    "style_replacing": (dict(style_vec_dim=24, style_replace_context=True),
                        {"style_vec": np.zeros((2, 3, 24), np.float32)}),
    "style_appended": (dict(style_vec_dim=24), {"style_vec": np.zeros((2, 24), np.float32)}),
    "cond_latents": (dict(img_conditioned=True),
                     {"cond_latents": np.zeros((2, 8, 32, 4), np.float32)}),
    "glyph_images": (dict(use_char_images=True),
                     {"char_images": np.zeros((2, 10, 16, 16, 1), np.float32)}),
    "ocr_head": (dict(ocr_head=True, ocr_hidden=64, ocr_classes=20), {}),
    "ocr_head_no_norm": (dict(ocr_head=True, ocr_hidden=64, ocr_classes=20, ocr_norm="none"),
                         {}),
}


@pytest.mark.parametrize("name", sorted(CONVERT_VARIANTS))
def test_jax_unet_to_torch_matches_the_exporter(name):
    """Key for key bitwise JAX's exporter + the extras wherever both give the
    key; every Flax parameter lands in one key; the port's UNet loads it
    with strict=True."""
    from worddiffusion_tpu_torch.models.unet import UNet

    kw, extra = CONVERT_VARIANTS[name]
    if extra == "phosc":
        cfg = UNetConfig(**{**kw, "channel_mult": tuple(kw["channel_mult"]),
                            "attention_resolutions": tuple(kw["attention_resolutions"])})
        extra = {"phosc_ids": np.zeros((2, cfg.phosc_dim), np.int32)}
    else:
        cfg = dataclasses.replace(IAM, **kw)
    shapes = jax.eval_shape(lambda r, *a: JaxUNet(cfg).init(r, *a, **extra),
                            jax.random.PRNGKey(0),
                            *_unet_init_args(cfg, hw=(64, 256) if cfg.in_channels == 3 else (8, 32)))
    params = random_tree(shapes, 7)
    got = jax_unet_to_torch(params, cfg)
    want = export_reference_unet(params, cfg)
    want.update(jax_unet_extras_to_torch(params, cfg))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].tobytes() == w.tobytes(), k
    assert sum(v.size for v in got.values()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params))
    UNet(port_cfg(cfg)).load_state_dict(state_dict_to_torch(got), strict=True)


# -- a JAX run's directories and the same weights in the port's files ---------------
# the VAE at one width through its four levels, and 32x128 images: the VAE
# decode is most of a CPU regeneration's time (the weights do not depend on
# the image size)
VAE_CFG = VAEConfig(base_channels=32, channel_mult=(1, 1, 1, 1), num_res_blocks=1,
                    dtype="float32")


def _jax_exp():
    return Experiment(vae=VAE_CFG, unet=CFG,
                      data=DataConfig(max_chars=10, img_height=32, img_width=128))


def write_jax_run(root) -> dict:
    """What the JAX CLIs leave: ``run/ckpt`` (the Trainer's TrainState at
    steps 4 and 8, every leaf random, a leftover temporary directory),
    ``run/writers_dict_train.json``, ``vae/ckpt`` and ``ocr/ckpt``
    (``cli.train_vae`` / ``cli.train_ocr``'s managers); and ``port/``, the
    same weights in the port's files (``ema_unet_<step>.pt``,
    ``unet_<step>.pt``, ``vae.pt``, ``ocr.pt``)."""
    root = str(root)
    os.makedirs(os.path.join(root, "port"))
    shapes = unet_shapes(CFG)
    mgr = JaxCheckpoints(os.path.join(root, "run", "ckpt"))
    trees = {}
    for step in (4, 8):
        params, ema = random_tree(shapes, step), random_tree(shapes, step + 1)
        mu, nu = random_tree(shapes, step + 2), random_tree(shapes, step + 3, square=True)
        mgr.save(step, JaxTrainState(step=jnp.int32(step), params=params, ema_params=ema,
                                     opt_state=adam_state(params, mu, nu, step)))
        trees[step] = dict(params=params, ema=ema, mu=mu, nu=nu)
        torch.save(state_dict_to_torch(jax_unet_to_torch(ema, CFG)),
                   os.path.join(root, "port", f"ema_unet_{step}.pt"))
        torch.save(state_dict_to_torch(jax_unet_to_torch(params, CFG)),
                   os.path.join(root, "port", f"unet_{step}.pt"))
    mgr.close()
    os.makedirs(os.path.join(root, "run", "ckpt", "12.orbax-checkpoint-tmp-1700000000"))
    with open(os.path.join(root, "run", "writers_dict_train.json"), "w") as f:
        json.dump({"w07": 5, "w09": 2}, f)
    h, w = 64, 256
    vae = random_tree(jax.eval_shape(JaxVAE(VAE_CFG).init, jax.random.PRNGKey(0),
                                     np.zeros((1, h, w, 3), np.float32),
                                     jax.random.PRNGKey(0)), 21)
    ocr = random_tree(jax.eval_shape(JaxOCR(num_classes=len(OCR_ENG)).init,
                                     jax.random.PRNGKey(0),
                                     np.zeros((1, h, w, 1), np.float32)), 22)
    for name, tree, sd in (("vae", vae, jax_vae_to_torch(vae, port_cfg(VAE_CFG))),
                           ("ocr", ocr, jax_ocr_to_torch(ocr))):
        side = ocp.CheckpointManager(os.path.join(root, name, "ckpt"),
                                     options=ocp.CheckpointManagerOptions(max_to_keep=2,
                                                                          create=True))
        side.save(30, args=ocp.args.StandardSave(tree))
        side.wait_until_finished()
        side.close()
        torch.save(state_dict_to_torch(sd), os.path.join(root, "port", f"{name}.pt"))
    gt = os.path.join(root, "words.filter27")
    with open(gt, "w") as f:
        f.write("w07,a01-000u-00 the\nw09,a01-001u-00 of\n")
    return dict(root=root, ckpt=os.path.join(root, "run", "ckpt"), trees=trees, gt=gt,
                vae_ckpt=os.path.join(root, "vae", "ckpt"),
                ocr_ckpt=os.path.join(root, "ocr", "ckpt"),
                port=os.path.join(root, "port"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return write_jax_run(tmp_path_factory.mktemp("jax_run"))


@pytest.fixture
def tiny_presets(monkeypatch):
    """The run's preset in both packages' registries (``tiny_orbax``)."""
    from worddiffusion_tpu_torch.configs import presets

    monkeypatch.setitem(jpresets.PRESETS, "tiny_orbax", _jax_exp)
    monkeypatch.setitem(presets.PRESETS, "tiny_orbax", lambda: port_cfg(_jax_exp()))
    return "tiny_orbax"


def _files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))
            if n.endswith(".png")}


@pytest.mark.parametrize("use_ema", [1, 0])
def test_regenerate_from_orbax_is_port_files_bitwise(jax_run, tiny_presets, tmp_path, use_ema,
                                                     monkeypatch):
    """cli.regenerate --ckpt_dir (the manager's directory) --use_ema 1|0
    --vae_ckpt against --torch_ckpt / --vae_pt of the same weights: the
    UNet's and the VAE's weights bitwise and, for the EMA, the PNGs of two
    DDIM steps bitwise (the writers dict found beside --ckpt_dir)."""
    from worddiffusion_tpu_torch.cli import regenerate as regen_cli

    r = jax_run
    base = ["--preset", tiny_presets, "--gt_file", r["gt"], "--ddim", "2", "--no_ocr_filter",
            "1", "--device", "cpu"]
    unet = f"{'ema_unet' if use_ema else 'unet'}_8.pt"
    argv = {"a": base + ["--ckpt_dir", r["ckpt"], "--use_ema", str(use_ema), "--vae_ckpt",
                         r["vae_ckpt"], "--dump_path", str(tmp_path / "a")],
            "b": base + ["--torch_ckpt", os.path.join(r["port"], unet), "--vae_pt",
                         os.path.join(r["port"], "vae.pt"), "--writers_dict",
                         os.path.join(r["root"], "run", "writers_dict_train.json"),
                         "--dump_path", str(tmp_path / "b")]}
    build, built = regen_cli.build, {}

    def build_and_keep(args):
        regen, samples = build(args)
        built[os.path.basename(args.dump_path)] = regen.sampler
        return regen, samples

    monkeypatch.setattr(regen_cli, "build", build_and_keep)
    for v in argv.values():  # main (build, then the run) for the EMA, build alone else
        if use_ema:
            regen_cli.main(v)
        else:
            regen_cli.build(regen_cli.build_parser().parse_args(v))
    for part in ("model", "vae"):
        sa, sb = (getattr(built[k], part).state_dict() for k in "ab")
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa), part
    if use_ema:
        a, b = _files(tmp_path / "a"), _files(tmp_path / "b")
        assert len(a) == 2 and a == b


def test_cache_and_train_clis_read_an_orbax_vae(jax_run, tiny_presets, tmp_path):
    """cli.build_latent_cache --vae_ckpt (orbax) writes the cache --vae_pt
    writes, bitwise; cli.train --vae_ckpt builds the same VAE. Both read
    ``--vae_ckpt <save_dir>/ckpt`` where ``<save_dir>`` holds the port
    trainer's ``vae.pt`` and no ``ckpt/`` (``train.checkpoint.side_file``)
    as that ``vae.pt``."""
    from worddiffusion_tpu_torch.cli import build_latent_cache as cache_cli
    from worddiffusion_tpu_torch.cli import train as train_cli

    r = jax_run
    side = tmp_path / "vae_syn"
    side.mkdir()
    shutil.copy(os.path.join(r["port"], "vae.pt"), side / "vae.pt")
    argv = ["--preset", tiny_presets, "--gt_train", r["gt"], "--iam_path",
            str(tmp_path / "none"), "--deterministic", "1", "--device", "cpu"]
    cache_cli.main(argv + ["--vae_ckpt", r["vae_ckpt"], "--out", str(tmp_path / "a.npz")])
    cache_cli.main(argv + ["--vae_pt", os.path.join(r["port"], "vae.pt"), "--out",
                           str(tmp_path / "b.npz")])
    cache_cli.main(argv + ["--vae_ckpt", str(side / "ckpt"), "--out", str(tmp_path / "c.npz")])
    a, b, c = (np.load(tmp_path / f"{k}.npz") for k in "abc")
    assert sorted(a.files) == sorted(b.files) == sorted(c.files) and len(a.files) == 2
    assert all(a[k].tobytes() == b[k].tobytes() == c[k].tobytes() for k in a.files)
    exp = port_cfg(_jax_exp())
    vaes = []
    for flags in (["--vae_ckpt", r["vae_ckpt"]], ["--vae_pt", os.path.join(r["port"], "vae.pt")],
                  ["--vae_ckpt", str(side / "ckpt")]):
        args = train_cli.build_parser().parse_args(["--preset", tiny_presets, *flags])
        vaes.append(train_cli._vae(args, exp, torch.device("cpu"), with_encoder=True).state_dict())
    for other in vaes[1:]:
        assert vaes[0].keys() == other.keys()
        assert all(torch.equal(vaes[0][k], other[k]) for k in vaes[0])


# -- resuming a JAX run --------------------------------------------------------------
def _datasets(n=32):
    """The same samples and latents in both packages' datasets."""
    from worddiffusion_tpu.data.dataset import LatentLookup as JLookup
    from worddiffusion_tpu.data.dataset import WordImageDataset as JDataset
    from worddiffusion_tpu.data.gt import Sample as JSample
    from worddiffusion_tpu.data.gt import WriterRegistry as JRegistry
    from worddiffusion_tpu.data.tokenizer import Tokenizer as JTokenizer
    from test_torch_train import _dataset

    port = _dataset(n)
    samples = [JSample(image=s.image, writer=s.writer, word=s.word) for s in port.samples]
    reg = JRegistry()
    for s in samples:
        reg.add(s.writer)
    rng = np.random.default_rng(0)
    cache = JLookup({s.image: rng.standard_normal((8, 32, 4)).astype(np.float32)
                     for s in samples})
    return port, JDataset(samples, reg, JTokenizer.from_name("eng_main", 10),
                          DataConfig(max_chars=10), latent_cache=cache)


def test_port_resumes_a_jax_run(tmp_path, monkeypatch):
    """The JAX Trainer's step function, optimizer and checkpoint manager
    take 2 steps from random parameters on its first two batches and write
    orbax, as ``Trainer.run`` does. The port's Trainer restores them: the parameters, the EMA and
    Adam's moments bitwise (through jax_unet_to_torch), step and count 2.
    Both take step 3 on the epoch's third batch with JAX's draws; JAX's
    gradient is read back from its moments, g = (mu3 - b1 mu2) / (1 - b1).
    Every gradient within 1e-4 of its largest entry (floored at 1e-2 of the
    largest anywhere), as the step test's; the parameters within 2e-6 + lr
    |u(g_port) - u(g_jax)|, u(g) Adam's update from the restored moments (at
    step 1 this is the step test's lr |f(g_port) - f(g_jax)|), the EMA
    within the same times 1 - beta; the moments within (1 - b1) |dg| and
    (1 - b2) |d(g^2)| plus 4 float32 ulps of their summands (torch's lerp
    and optax's b1 m + (1 - b1) g round differently)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from worddiffusion_tpu.data.loader import epoch_batches as jax_batches
    from worddiffusion_tpu.diffusion import forward as jforward
    from worddiffusion_tpu.train import step as jstep
    from worddiffusion_tpu.train.loop import Trainer as JaxTrainer
    from worddiffusion_tpu_torch.train import checkpoint
    from worddiffusion_tpu_torch.train import step as port_step
    from worddiffusion_tpu_torch.train.loop import Trainer
    from worddiffusion_tpu_torch.train.step import StepDraws

    port_ds, jds = _datasets()
    jexp = tiny_exp(tmp_path / "jax", lr=1e-3)
    jt = JaxTrainer(jexp, jds)
    batches = [jt._device_batch(b) for b in jax_batches(jds, 8, epoch=0, seed=jexp.train.seed)]
    rng = jax.random.PRNGKey(jexp.train.seed + 1)
    train_step = jax.jit(jstep.make_train_step(jt.model, jt.schedule, jexp, jt.tx))
    # every parameter random (the zero-initialised output convs would hide sub-paths),
    # placed as the step places its output, so that the step is traced once
    state = JaxTrainState.create(random_tree(unet_shapes(jt.model.cfg), 3), jt.tx)
    state = jax.device_put(state, NamedSharding(jt.mesh, P()))
    for b in batches[:2]:
        state = train_step(state, b, rng)[0]
    state2 = state
    jt.ckpt.save(2, state2)
    state3 = train_step(state2, batches[2], rng)[0]
    assert orbax_steps(str(tmp_path / "jax" / "ckpt")) == [2]
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    t_rng, n_rng, d_rng = jax.random.split(jax.random.fold_in(rng, 2), 3)
    t = np.asarray(jforward.sample_timesteps(jt.schedule, t_rng, 8))
    noise = np.asarray(jax.random.normal(n_rng, (8, 8, 32, 4), jnp.float32))
    keep = float(jax.random.uniform(d_rng, ()) >= jexp.train.cfg_drop_prob)

    # the Trainer's resume reads the JAX step once; what it restored is kept
    restore_jax, got = checkpoint.restore_jax, {}

    def restore_and_keep(state, step_dir, mesh=None):
        st = restore_jax(state, step_dir, mesh)
        got.update(step=st.step, opt=copy.deepcopy(st.optimizer.state_dict()["state"]),
                   model=copy.deepcopy(st.model.state_dict()),
                   ema=copy.deepcopy(st.ema.state_dict()))
        return st

    monkeypatch.setattr(checkpoint, "restore_jax", restore_and_keep)
    monkeypatch.setattr(port_step, "draw_step", lambda *a, **k: StepDraws(
        torch.from_numpy(t.copy()).long(), torch.from_numpy(noise.copy()), torch.tensor(keep)))
    exp = port_cfg(tiny_exp(tmp_path / "port", lr=1e-3))
    st3 = Trainer(exp, port_ds, device="cpu").run(epochs=1, max_steps=3, resume=True)
    assert got["step"] == 2 and st3.step == 3
    adam2, adam3 = state2.opt_state[0], state3.opt_state[0]
    assert int(adam2.count) == 2
    names = [n for n, _ in st3.model.named_parameters()]
    want = {"model": jax_unet_to_torch(state2.params, CFG),
            "ema": jax_unet_to_torch(state2.ema_params, CFG),
            "exp_avg": jax_unet_to_torch(adam2.mu, CFG),
            "exp_avg_sq": jax_unet_to_torch(adam2.nu, CFG)}
    opt = got["opt"]
    for i, n in enumerate(names):
        assert opt[i]["step"].item() == 2.0
        for k in ("exp_avg", "exp_avg_sq"):
            assert opt[i][k].numpy().tobytes() == want[k][n].tobytes(), (k, n)
        for k in ("model", "ema"):
            assert got[k][n].numpy().tobytes() == want[k][n].tobytes(), (k, n)

    b1, b2, eps, lr, beta = 0.9, 0.999, 1e-8, exp.train.lr, exp.train.ema_beta
    ulp = 4 * np.finfo(np.float32).eps
    new = {"model": jax_unet_to_torch(state3.params, CFG),
           "ema": jax_unet_to_torch(state3.ema_params, CFG),
           "exp_avg": jax_unet_to_torch(adam3.mu, CFG),
           "exp_avg_sq": jax_unet_to_torch(adam3.nu, CFG)}
    g_j = {n: (new["exp_avg"][n] - b1 * want["exp_avg"][n]) / (1 - b1) for n in names}
    floor = 1e-2 * max(np.abs(w).max() for w in g_j.values())
    opt3 = st3.optimizer.state_dict()["state"]

    def u(g, m, v):
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        return (m / (1 - b1 ** 3)) / (np.sqrt(v / (1 - b2 ** 3)) + eps)

    ema_params = dict(st3.ema.named_parameters())
    for i, (n, p) in enumerate(st3.model.named_parameters()):
        g_p, g, m2, v2 = p.grad.numpy(), g_j[n], want["exp_avg"][n], want["exp_avg_sq"][n]
        np.testing.assert_allclose(g_p, g, rtol=0, atol=1e-4 * max(np.abs(g).max(), floor),
                                   err_msg=n)
        adam_diff = lr * np.abs(u(g_p, m2, v2) - u(g, m2, v2))
        assert (np.abs(p.detach().numpy() - new["model"][n]) <= 2e-6 + adam_diff).all(), n
        assert (np.abs(ema_params[n].numpy() - new["ema"][n])
                <= 2e-6 + (1 - beta) * adam_diff).all(), n
        # the rounding of either side's summands
        m_terms = b1 * np.abs(m2) + (1 - b1) * np.maximum(np.abs(g_p), np.abs(g))
        assert (np.abs(opt3[i]["exp_avg"].numpy() - new["exp_avg"][n])
                <= ulp * m_terms + (1 - b1) * np.abs(g_p - g)).all(), n
        v_terms = b2 * v2 + (1 - b2) * np.maximum(g_p * g_p, g * g)
        assert (np.abs(opt3[i]["exp_avg_sq"].numpy() - new["exp_avg_sq"][n])
                <= ulp * v_terms + (1 - b2) * np.abs(g_p * g_p - g * g)).all(), n
        assert opt3[i]["step"].item() == 3.0
    assert sorted(os.listdir(tmp_path / "port" / "ckpt")) == ["2", "3"]
    assert os.path.isfile(tmp_path / "port" / "ckpt" / "3" / "state.pt")


@pytest.fixture(scope="module")
def resumed_run(jax_run, tmp_path_factory):
    """cli.train --loadPrev 1 on a copy of the JAX run's --save_path (its
    ckpt/ holds the JAX Trainer's orbax steps 4 and 8 and no port step):
    -> (save path, the final TrainState, the step directories restore_jax
    read)."""
    from test_torch_train import _cli_files
    from worddiffusion_tpu_torch.cli import train as train_cli
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.train import checkpoint

    tmp = tmp_path_factory.mktemp("resumed")
    gt, cache = _cli_files(tmp)
    save = tmp / "run"
    shutil.copytree(os.path.join(jax_run["root"], "run"), save)
    seen = []
    restore_jax = checkpoint.restore_jax
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
        mp.setattr(checkpoint, "restore_jax",
                   lambda s, d, mesh=None: seen.append(d) or restore_jax(s, d, mesh))
        state = train_cli.main(["--preset", "tiny", "--gt_train", gt, "--latent_cache", cache,
                                "--batch_size", "4", "--epochs", "3", "--save_path", str(save),
                                "--loadPrev", "1", "--preview_ddim", "2", "--device", "cpu"])
    return save, state, seen


def test_train_cli_load_prev_continues_a_jax_run(resumed_run):
    """cli.train --loadPrev 1 on a --save_path whose ckpt/ holds the JAX
    Trainer's orbax steps (4 and 8) and no port step: resumes at step 8 (the
    epoch and batch offset of the resume contract: 12 words at batch 4,
    epoch 2, batch 2), takes the epoch's last step and writes the port's
    checkpoint; the orbax steps are left as they were."""
    from worddiffusion_tpu_torch.train import checkpoint

    save, state, seen = resumed_run
    assert seen == [os.path.join(str(save), "ckpt", "8")]
    assert state.step == 9
    assert orbax_steps(str(save / "ckpt")) == [4, 8]
    assert checkpoint.checkpoint_steps(str(save / "ckpt")) == [9]


def test_readers_read_the_port_steps_after_a_resume(resumed_run, jax_run, monkeypatch,
                                                    tmp_path):
    """After the resume, ckpt/ holds the JAX steps 4 and 8 and the port's
    step 9. Every reader takes the port's step 9 first (the continued run):
    read_unet, the regeneration CLI's --ckpt_dir (--use_ema 1 and 0), the
    CheckpointManager; export_reference --step 9 exports it, --step 8 the
    JAX step, and an absent step exits naming both layouts."""
    from worddiffusion_tpu_torch.cli import export_reference as export_cli
    from worddiffusion_tpu_torch.cli import regenerate as regen_cli
    from worddiffusion_tpu_torch.cli.sample import load_unet
    from worddiffusion_tpu_torch.configs import presets
    from worddiffusion_tpu_torch.models.convert import port_unet_to_reference
    from worddiffusion_tpu_torch.train import checkpoint

    monkeypatch.setitem(presets.PRESETS, "tiny", lambda: port_cfg(tiny_exp()))
    save, state, _ = resumed_run
    ckpt = str(save / "ckpt")
    exp = presets.get("tiny")
    assert checkpoint.locate(ckpt)[:2] == (False, 9)
    assert checkpoint.locate(ckpt, 8)[:2] == (True, 8)
    assert checkpoint.CheckpointManager(ckpt).latest_step() == 9

    def same(got, want):
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)

    same(checkpoint.read_unet(ckpt, cfg=exp.unet), state.ema.state_dict())
    for use_ema, module in ((1, state.ema), (0, state.model)):
        args = regen_cli.build_parser().parse_args(
            ["--preset", "tiny", "--gt_file", jax_run["gt"], "--ckpt_dir", ckpt,
             "--use_ema", str(use_ema), "--device", "cpu"])
        same(load_unet(exp, args).state_dict(), module.state_dict())
    for step, ema in ((9, state.ema.state_dict()),
                      (8, state_dict_to_torch(jax_unet_to_torch(jax_run["trees"][8]["ema"],
                                                                CFG)))):
        out = export_cli.main(["--preset", "tiny", "--ckpt_dir", ckpt, "--step", str(step),
                               "--out", str(tmp_path / f"{step}.pt")])
        same(out, port_unet_to_reference(ema, exp.unet))
    with pytest.raises(SystemExit, match="of step 7.*orbax"):
        export_cli.main(["--preset", "tiny", "--ckpt_dir", ckpt, "--step", "7", "--out",
                         str(tmp_path / "7.pt")])


# -- the committed check set ---------------------------------------------------------
def _key(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", ""))))
                    for k in path)


def _tiled(shapes, rule_of, prefix=""):
    """A numpy tree of ``shapes`` whose leaves follow ``orbax_check``'s rule."""
    def leaf(path, s):
        key = prefix + _key(path)
        rule = rule_of(key)
        if isinstance(rule, dict):
            return np.full(s.shape, rule["const"], s.dtype)
        if rule == "zero":
            return np.zeros(s.shape, s.dtype)
        return orbax_check.seeded_leaf(key, s.shape, rule).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _leaf_list(tree, rule_of) -> list:
    return [[_key(path), list(np.shape(v)), np.asarray(v).dtype.str, rule_of(_key(path))]
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


# the seed of each tiled tree: the UNet's parameters and EMA differ
SEEDS = {"params": 1, "ema_params": 2, "vae": 3, "ocr": 4}


def tiled_rule(path: str, set_name: str):
    """The rule of a leaf of a tiled set: a seed, ``"zero"`` (Adam's moments)
    or the step (the step and the Adam count)."""
    top = path.split(".")[0]
    if set_name != "iam":
        return SEEDS[set_name]
    if top == "step" or path.endswith(".count"):
        return {"const": orbax_check.STEP}
    return SEEDS[top] if top in SEEDS else "zero"


def _narrow_rule(key: str):
    """The narrow set's parameters are stored; the EMA is their copy, the
    moments zero."""
    top = key.split(".")[0]
    if top == "step" or key.endswith(".count"):
        return {"const": 3 if top == "step" else 0}
    if top == "ema_params":
        return "same:params" + key[len(top):]
    return "stored" if top == "params" else "zero"


def make_check_set(out_path: str, work: str) -> None:
    """Writes ``orbax_check.npz``: the JAX package's checkpoints of the four
    sets (see ``worddiffusion_tpu_torch/train/orbax_check.py``), their files
    and what they decode to. ``work``: a scratch directory."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    arrays = {}
    # (i) narrow, random, sharded over 2 devices
    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    params = {"params": {
        "dense": {"kernel": jax.device_put(rng.standard_normal((256, 160)).astype(np.float32),
                                           NamedSharding(mesh, P(None, "model"))),
                  "bias": jnp.asarray(rng.standard_normal(160).astype(np.float32))},
        "emb": jax.device_put(jnp.asarray(rng.standard_normal((128, 96)), jnp.bfloat16),
                              NamedSharding(mesh, P("model", None))),
        "ids": jnp.asarray(rng.integers(0, 1000, (64, 33)).astype(np.int32)),
        "scale": jnp.float32(0.5)}}
    state = JaxTrainState.create(params, jax_optimizer(1e-4)).replace(step=jnp.int32(3))
    JaxCheckpoints(os.path.join(work, "narrow", "ckpt")).save(3, state)
    leaves = _leaf_list({"step": state.step, "params": state.params,
                         "opt_state": state.opt_state, "ema_params": state.ema_params},
                        _narrow_rule)
    restored = restored_leaves(os.path.join(work, "narrow", "ckpt", "3"))
    for entry in leaves:  # bfloat16 leaves are expected as their uint16 bits
        entry[2] = restored[entry[0]].dtype.str
        if entry[3] == "stored":
            arrays[f"expected/narrow/{entry[0]}"] = restored[entry[0]]
    arrays["leaves/narrow"] = np.frombuffer(json.dumps(leaves).encode(), np.uint8)
    # (ii) the full-width iam TrainState, tiled
    iam = jpresets.get("iam").unet
    shapes = unet_shapes(iam)

    def rule(key):
        return tiled_rule(key, "iam")

    p, e = _tiled(shapes, rule, "params."), _tiled(shapes, rule, "ema_params.")
    zeros = jax.tree_util.tree_map(np.zeros_like, p)
    state = JaxTrainState(step=jnp.int32(orbax_check.STEP), params=p, ema_params=e,
                          opt_state=adam_state(p, zeros, zeros, orbax_check.STEP))
    JaxCheckpoints(os.path.join(work, "iam", "ckpt")).save(orbax_check.STEP, state)
    arrays["leaves/iam"] = np.frombuffer(json.dumps(_leaf_list(
        {"step": state.step, "params": p, "opt_state": state.opt_state, "ema_params": e},
        rule)).encode(), np.uint8)
    # (iii) the VAE and the OCR at the preset's width, as their trainers write them
    h, w = 64, 256
    vae = jax.eval_shape(JaxVAE(jpresets.get("iam").vae).init, jax.random.PRNGKey(0),
                         np.zeros((1, h, w, 3), np.float32), jax.random.PRNGKey(0))
    ocr = jax.eval_shape(JaxOCR(num_classes=len(OCR_ENG)).init, jax.random.PRNGKey(0),
                         np.zeros((1, h, w, 1), np.float32))
    for name, shapes in (("vae", vae), ("ocr", ocr)):
        def side_rule(key, name=name):
            return tiled_rule(key, name)

        tree = _tiled(shapes, side_rule)
        mgr = ocp.CheckpointManager(os.path.join(work, name, "ckpt"),
                                    options=ocp.CheckpointManagerOptions(max_to_keep=2,
                                                                         create=True))
        mgr.save(40, args=ocp.args.StandardSave(tree))
        mgr.wait_until_finished()
        mgr.close()
        arrays[f"leaves/{name}"] = np.frombuffer(json.dumps(_leaf_list(tree, side_rule))
                                                 .encode(), np.uint8)
    for name in orbax_check.SETS:
        base = os.path.join(work, name)
        for d, _, files in os.walk(base):
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), base)
                with open(os.path.join(d, f), "rb") as fh:
                    arrays[f"files/{name}/{rel}"] = np.frombuffer(fh.read(), np.uint8)
    np.savez_compressed(out_path, **arrays)


def _check(path: str, tmp) -> None:
    for name in orbax_check.SETS:
        d = orbax_check.unpack(name, str(tmp / name), path)
        got = orbax_check.flatten(read_orbax(os.path.join(d, "ckpt")))
        assert_bitwise(got, orbax_check.expected(name, path))


def test_committed_check_set_decodes(tmp_path):
    """The committed set: each directory decodes to its expected arrays
    (the narrow set's stored ones, the tiled sets' seed rule), and it stays
    under 2 MB."""
    assert os.path.getsize(orbax_check.CHECK_FILE) < 2 * 2 ** 20
    _check(orbax_check.CHECK_FILE, tmp_path)


def test_check_set_written_anew_decodes(tmp_path):
    """The generator run again: the new files (other data file names, other
    uuids) decode to the same arrays as the committed set says."""
    out = str(tmp_path / "check.npz")
    make_check_set(out, str(tmp_path / "work"))
    for name in orbax_check.SETS:
        assert_bitwise(orbax_check.expected(name, out), orbax_check.expected(name))
    _check(out, tmp_path / "read")


if __name__ == "__main__":
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    with tempfile.TemporaryDirectory() as work:
        make_check_set(orbax_check.CHECK_FILE, work)
    print(orbax_check.CHECK_FILE, os.path.getsize(orbax_check.CHECK_FILE), "bytes")
