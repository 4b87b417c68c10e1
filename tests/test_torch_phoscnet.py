"""The port's PHOSC recognizer against the JAX package's, on the same seeded
weights and inputs, on the CPU in fp32 (bf16 stated loosely): the pyramid
pools at even and uneven widths, every trunk (both norms), PHOSCNet with its
features, the pretrain variant, the prompter, ``phosc_loss``, the BN-folding
torchvision converter, the stem's asymmetric SAME padding at 50x250, the
character counter, and three AdamW + reduce-on-plateau training steps
against optax. The recognizer reaches no Pallas kernel in JAX; its
GroupNorms are B.5's plain version here.

Tolerances: fp32 outputs within 1e-4 of max |JAX| (the two sides sum
convolutions in different orders, about 1e-6 apart); bf16 within 5e-2 of
max |JAX| (a bf16 rounding, 0.4%, at each of the layers, in both packages
at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_phosc_trunks import TorchRefTrunk
from worddiffusion_tpu.models import charcounter as jcharcounter
from worddiffusion_tpu.models import phoscnet as jphoscnet
from worddiffusion_tpu_torch.cli.train_phosc import train_step
from worddiffusion_tpu_torch.models import charcounter, phoscnet
from worddiffusion_tpu_torch.models.convert import (jax_charcounter_to_torch,
                                                    jax_phoscnet_to_torch, state_dict_to_torch,
                                                    torch_phoscnet_to_jax)
from worddiffusion_tpu_torch.train.plateau import ReduceOnPlateau
from worddiffusion_tpu_torch.train.state import make_optimizer

torch.set_num_threads(2)
FP32_TOL, BF16_TOL = 1e-4, 5e-2


def _randomize(tree, seed: int):
    """Seeded GroupNorm affines around identity and non-zero biases (flax
    initialises them to 1 and 0), so that each enters the comparison."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        a = np.array(a, np.float32)
        if name == "scale":
            return a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
        if name == "bias":
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _init(module, x, seed: int = 0):
    return _randomize(jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(seed), x)), seed)


def _load(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(state_dict_to_torch(jax_phoscnet_to_torch(variables)))
    return module


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW (channels_last memory, a view)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("pool,levels", [("temporal", (1, 2, 5)), ("spatial", (1, 2, 4))])
@pytest.mark.parametrize("h,w", [(3, 23), (3, 2), (5, 250), (7, 9)])
def test_pyramid_pool_matches_jax(pool, levels, h, w):
    """-inf padding split as JAX splits it, windows of padding only -> 0 (W=2
    at level 5: three of five stripes), and the flatten order (stripe- or
    cell-major, channel-minor): bitwise equal, as a max is exact."""
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 6)).astype(np.float32)
    jfn, fn = {"temporal": (jphoscnet.temporal_pyramid_pool, phoscnet.temporal_pyramid_pool),
               "spatial": (jphoscnet.spatial_pyramid_pool, phoscnet.spatial_pyramid_pool)}[pool]
    want = np.asarray(jfn(jnp.asarray(x), levels))
    got = fn(_nchw(x), levels).numpy()
    assert np.array_equal(got, want)
    if w == 2:
        assert (got == 0).any()


# (trunk, norm): the norm only changes the torchvision-layout trunks
TRUNK_CASES = [("vgg", "group"), ("resnet18", "group")] + [
    (t, n) for t in ("resnet18_pretrain", "resnet18_attention", "resnet34")
    for n in ("group", "none")]


@pytest.mark.parametrize("trunk,norm", TRUNK_CASES)
def test_trunk_matches_jax(trunk, norm):
    x = np.random.default_rng(1).standard_normal((2, 18, 46, 3)).astype(np.float32)
    jtrunk = jphoscnet.TRUNKS[trunk](jnp.float32, norm)
    variables = _init(jtrunk, x)
    want = np.asarray(jtrunk.apply(variables, x))
    port = _load(phoscnet.TRUNKS[trunk](norm), variables)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, want, FP32_TOL)
    n_norms = sum(isinstance(m, torch.nn.GroupNorm) for m in port.modules())
    assert n_norms == (0 if norm == "none" else {
        "vgg": 0, "resnet18": 16, "resnet34": 36}.get(trunk, 20))


def test_grayscale_input_broadcasts_like_jax():
    x = np.random.default_rng(2).standard_normal((1, 18, 46, 1)).astype(np.float32)
    jtrunk = jphoscnet.TRUNKS["resnet18_pretrain"](jnp.float32, "group")
    variables = _init(jtrunk, x)
    port = _load(phoscnet.TRUNKS["resnet18_pretrain"]("group"), variables)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _close(got, np.asarray(jtrunk.apply(variables, x)), FP32_TOL)


@pytest.mark.parametrize("trunk", ["resnet18", "vgg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phoscnet_matches_jax(trunk, dtype):
    """phos, phoc and the fp32 TPP features, and the carried weights' round
    trip back to the same flax tree."""
    x = np.random.default_rng(3).uniform(-1, 1, (2, 18, 46, 3)).astype(np.float32)
    jmodel = jphoscnet.PHOSCNet(hidden=32, trunk=trunk, dtype=getattr(jnp, dtype))
    variables = _init(jmodel, x)
    want = jmodel.apply(variables, x, return_features=True)
    port = _load(phoscnet.PHOSCNet(hidden=32, trunk=trunk, dtype=getattr(torch, dtype)),
                 variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x), return_features=True)
    assert set(got) == {"phos", "phoc", "features"}
    for k in got:
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), want[k], FP32_TOL if dtype == "float32" else BF16_TOL)
    back = torch_phoscnet_to_jax(port.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                     jax.tree_util.tree_leaves(variables)))


def test_resnet18_pretrain_phoscnet_matches_jax():
    x = np.random.default_rng(4).uniform(-1, 1, (2, 18, 46, 3)).astype(np.float32)
    jmodel = jphoscnet.resnet18_pretrain_phoscnet(hidden=32, dtype=jnp.float32)
    variables = _init(jmodel, x)
    want = jmodel.apply(variables, x)
    port = _load(phoscnet.resnet18_pretrain_phoscnet(hidden=32, dtype=torch.float32), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got["phos"].shape == (2, 180) and got["phoc"].shape == (2, 646)
    assert port.head_layers == 1 and not hasattr(port, "phos_fc1")
    for k in got:
        _close(got[k].numpy(), want[k], FP32_TOL)


def test_prompter_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 50, 250, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jphoscnet.FixedPatchPrompter().init(
        jax.random.PRNGKey(0), x))
    port = phoscnet.FixedPatchPrompter()
    port.load_state_dict(state_dict_to_torch(jax_phoscnet_to_torch(variables)))
    assert port.patch.shape == (1, 50, 250, 3)
    got = port(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jphoscnet.FixedPatchPrompter().apply(variables, x))
    assert np.array_equal(got, want)


def test_phosc_loss_matches_jax():
    rng = np.random.default_rng(6)
    pred = {"phos": rng.uniform(0, 2, (5, 165)).astype(np.float32),
            "phoc": rng.uniform(0, 1, (5, 604)).astype(np.float32)}
    tp = rng.integers(0, 3, (5, 165)).astype(np.float32)
    tc = (rng.random((5, 604)) < 0.1).astype(np.float32)
    want = float(jphoscnet.phosc_loss({k: jnp.asarray(v) for k, v in pred.items()}, tp, tc))
    got = phoscnet.phosc_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                              torch.from_numpy(tp), torch.from_numpy(tc)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


def test_convert_torchvision_resnet_matches_jax():
    """A seeded torchvision-layout resnet18 (random BatchNorm statistics):
    the port's folded state dict is JAX's tree in OIHW, and the folded trunk
    (norm "none") gives the eval-mode torchvision trunk's output."""
    torch.manual_seed(0)
    ref = TorchRefTrunk().eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    got = phoscnet.convert_torchvision_resnet(sd)
    want = jphoscnet.convert_torchvision_resnet(sd)
    assert sorted(got) == sorted(f"{n}.{p}" for n in want for p in ("weight", "bias"))
    for name, node in want.items():
        np.testing.assert_allclose(got[name + ".weight"], node["kernel"].transpose(3, 2, 0, 1),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(got[name + ".bias"], node["bias"], rtol=0, atol=0)
    trunk = phoscnet.TRUNKS["resnet18_pretrain"]("none")
    trunk.load_state_dict(state_dict_to_torch(got))
    x = np.random.default_rng(7).standard_normal((2, 18, 46, 3)).astype(np.float32)
    with torch.no_grad():
        out = trunk(_nchw(x)).numpy()
        want_out = ref(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    _close(out, want_out, FP32_TOL)


def test_stem_same_padding_is_asymmetric_at_50x250():
    """flax pads the 7x7 stride-2 stem on 50x250 by 2 before and 3 after on
    each axis; torch's symmetric padding=3 gives the same size, shifted.
    The whole _ResNet18Trunk at the CLI's input size, narrow batch."""
    assert phoscnet._same_pads(50, 7, 2) == (2, 3) and phoscnet._same_pads(250, 7, 2) == (2, 3)
    assert phoscnet._same_pads(25, 3, 2) == (1, 1) and phoscnet._same_pads(125, 1, 2) == (0, 0)
    x = np.random.default_rng(8).uniform(-1, 1, (1, 50, 250, 3)).astype(np.float32)
    jtrunk = jphoscnet.TRUNKS["resnet18"](jnp.float32, "group")
    variables = _init(jtrunk, x)
    port = _load(phoscnet.TRUNKS["resnet18"]("group"), variables)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
        stem = port.stem(_nchw(x)).permute(0, 2, 3, 1).numpy()
        symmetric = torch.nn.functional.conv2d(_nchw(x), port.stem.weight, port.stem.bias, 2,
                                               3).permute(0, 2, 3, 1).numpy()
    stem_p = variables["params"]["stem"]
    want_stem = np.asarray(jax.lax.conv_general_dilated(
        x, stem_p["kernel"], (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        + stem_p["bias"])
    assert got.shape == (1, 13, 63, 512)
    _close(stem, want_stem, FP32_TOL)
    assert np.abs(symmetric - want_stem).max() > 1e-2 * np.abs(want_stem).max()
    _close(got, np.asarray(jtrunk.apply(variables, x)), FP32_TOL)


def test_channels_last_reaches_every_groupnorm():
    """The NHWC input becomes a channels_last NCHW view, and every GroupNorm
    of the trunk gets a channels_last tensor, so B.5's NHWC view is no copy."""
    model = phoscnet.PHOSCNet(hidden=8, trunk="resnet18", dtype=torch.float32)
    seen = []
    for m in model.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.register_forward_pre_hook(lambda m, a: seen.append(
                a[0].is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        model(torch.zeros(1, 50, 250, 3))
    assert len(seen) == 16 and all(seen)


def test_dropout_draws_from_the_generator():
    """flax's Dropout: kept values scaled by 1/keep, masks from the
    generator (the same seed, the same output), none when deterministic."""
    model = phoscnet.PHOSCNet(hidden=64, trunk="vgg", dropout=0.5, dtype=torch.float32)
    h = torch.ones(4, 2048)
    a = model._dropout(h, torch.Generator().manual_seed(0))
    b = model._dropout(h, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (a > 0).float().mean().item() < 0.6
    with pytest.raises(ValueError, match="Generator"):
        model._dropout(h, None)


def test_charcounter_matches_jax():
    x = np.random.default_rng(9).uniform(-1, 1, (2, 18, 46, 3)).astype(np.float32)
    jmodel = jcharcounter.CharacterCounterNet(dtype=jnp.float32)
    variables = _init(jmodel, x)
    port = charcounter.CharacterCounterNet(dtype=torch.float32)
    port.load_state_dict(state_dict_to_torch(jax_charcounter_to_torch(variables)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _close(got, np.asarray(jmodel.apply(variables, x)), FP32_TOL)
    words = ["a", "the", "", "x" * 30]
    onehot = charcounter.length_onehot(words)
    assert np.array_equal(onehot.numpy(), np.asarray(jcharcounter.length_onehot(words)))
    probs = np.random.default_rng(10).dirichlet(np.ones(17), 4).astype(np.float32)
    want = float(jcharcounter.counter_loss(jnp.asarray(probs), jnp.asarray(onehot.numpy())))
    assert abs(charcounter.counter_loss(torch.from_numpy(probs), onehot).item() - want) \
        <= 1e-6 * abs(want)


def test_train_steps_match_jax():
    """Three AdamW (weight decay 5e-5) steps under the plateau schedule
    (patience 1: the third step runs at a quarter of the rate), dropout 0,
    against ``optax.chain(adamw, reduce_on_plateau)`` as the JAX CLI builds
    it: each step's loss and scale, the first step's gradients and the
    parameters it gives. Adam's first step is lr x g / (|g| + eps), about lr
    x sign(g): it compares closely where the gradient is clear of the
    gradients' own tolerance (1e-3 of the leaf's largest, ten times it); a
    smaller gradient's sign may differ, so those move by at most 2 lr apart."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (3, 18, 46, 3)).astype(np.float32)
    tp = rng.integers(0, 3, (3, 165)).astype(np.float32)
    tc = (rng.random((3, 604)) < 0.1).astype(np.float32)
    values = [1e9, -0.5, -0.5]
    lr = 1e-4  # the CLI's
    jmodel = jphoscnet.PHOSCNet(hidden=32, trunk="resnet18", dropout=0.0, dtype=jnp.float32)
    params = _init(jmodel, x)
    tx = optax.chain(optax.adamw(lr, weight_decay=5e-5), optax.contrib.reduce_on_plateau(
        factor=0.25, patience=1, cooldown=0, atol=1e-4))

    # jitted, as the JAX CLI's step (op-by-op, this JAX's CPU gradient of the
    # last block's first conv is 4% off a float64 reference; jitted, 2e-6)
    @jax.jit
    def grad_fn(p):
        return jax.value_and_grad(lambda q: jphoscnet.phosc_loss(
            jmodel.apply(q, x, deterministic=False), tp, tc))(p)

    port = _load(phoscnet.PHOSCNet(hidden=32, trunk="resnet18", dropout=0.0,
                                   dtype=torch.float32), params)
    optimizer = make_optimizer(port.parameters(), lr, weight_decay=5e-5)
    plateau = ReduceOnPlateau(factor=0.25, patience=1, cooldown=0, atol=1e-4)
    gen = torch.Generator().manual_seed(0)
    opt_state, scales = tx.init(params), []
    for i, value in enumerate(values):
        loss, grads = grad_fn(params)
        updates, opt_state = tx.update(grads, opt_state, params, value=value)
        start, params = params, optax.apply_updates(params, updates)
        scales.append(float(opt_state[1].scale))
        got = train_step(port, optimizer, torch.from_numpy(x), torch.from_numpy(tp),
                         torch.from_numpy(tc), gen, plateau, lr, value)
        assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss)), i
        assert float(plateau.scale) == scales[-1] and optimizer.param_groups[0]["lr"] == \
            lr * scales[-1]
        if i > 0:
            continue
        port_grads = torch_phoscnet_to_jax({k: p.grad for k, p in port.named_parameters()})
        after = torch_phoscnet_to_jax(port.state_dict())
        for g_port, g, a, b, p0 in zip(*(jax.tree_util.tree_leaves(t) for t in (
                port_grads, grads, after, params, start))):
            g, b = np.asarray(g), np.asarray(b)
            _close(g_port, g, FP32_TOL)
            assert not np.array_equal(b, p0)  # every parameter moved
            clear = np.abs(g) >= 10 * FP32_TOL * np.abs(g).max()
            assert np.abs(a - b).max() <= 2 * lr
            assert np.abs(a - b)[clear].max() <= 1e-3 * lr
    assert scales == [1.0, 1.0, 0.25]


def _rendered_words(n_words: int = 8, per_word: int = 4, b: int = 4):
    """Renders of the first ``n_words`` synthetic words at 16x48 (3x5 block
    means of the 50x250 crops, so that a CPU step takes a tenth of a second)
    and their PHOS / PHOC targets, in batches of ``b``."""
    from worddiffusion_tpu_torch.data.phoc import phoc_labels
    from worddiffusion_tpu_torch.data.phos import phos_labels
    from worddiffusion_tpu_torch.data.synthetic import render_word, word_list

    words = word_list(n_words)
    phos, phoc = phos_labels(words, "eng"), phoc_labels(words, "eng")
    order = np.random.default_rng(5).permutation(n_words * per_word)
    x, tp, tc = [], [], []
    for i in order:
        w = words[i % n_words]
        crop = render_word(w, 50, 250, seed=1000 + int(i))[:48, :240] / 127.5 - 1.0
        x.append(crop.reshape(16, 3, 48, 5, 3).mean(axis=(1, 3)))
        tp.append(phos[w])
        tc.append(phoc[w])
    return [tuple(np.asarray(a[s:s + b], np.float32) for a in (x, tp, tc))
            for s in range(0, len(x), b)]


def test_train_steps_match_jax_along_a_trajectory():
    """200 steps of the CLI's AdamW (weight decay 5e-5, lr 3e-4 as the
    PHOSC recipes) under reduce-on-plateau (patience 5 and cooldown 2
    epochs of 10 steps, a scripted validation accuracy that rises, then
    stalls: the rate is cut twice), dropout 0, on the VGG trunk in fp32 over
    rendered words and their PHOS / PHOC targets. Run free, the two
    trajectories part within tens of steps (fp32 sums in another order,
    amplified by Adam where a gradient is small against its history), so at
    each step the port starts from JAX's parameters and Adam moments there.
    Each step's loss (1e-5 relative) and plateau scale are JAX's; its
    gradients are within 1e-3 of the model's largest gradient (where a
    forward value lies within fp32 noise of a ReLU's zero or of a max-pool
    tie, the two sides send that element's gradient different ways: up to
    3.6e-4 of the largest in a few of the 200 steps, too much for a bound
    per leaf); and the parameters after it are optax's update of the port's
    own gradients, within 1e-3 of the step's rate and two fp32 spacings."""
    batches = _rendered_words()
    steps, epoch, lr = 200, 10, 3e-4
    accs = [min(0.1 * e, 0.6) for e in range(steps // epoch)]
    jmodel = jphoscnet.PHOSCNet(hidden=32, trunk="vgg", dropout=0.0, dtype=jnp.float32)
    # jitted: op by op, flax's init compiles each layer's draws (14 s)
    params = _randomize(jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                            batches[0][0])), 0)
    tx = optax.chain(optax.adamw(lr, weight_decay=5e-5), optax.contrib.reduce_on_plateau(
        factor=0.25, patience=5 * epoch, cooldown=2 * epoch, atol=1e-4))

    @jax.jit
    def step_fn(p, state, x, tp, tc, value):
        loss, grads = jax.value_and_grad(lambda q: jphoscnet.phosc_loss(
            jmodel.apply(q, x, deterministic=False), tp, tc))(p)
        updates, state = tx.update(grads, state, p, value=value)
        return optax.apply_updates(p, updates), state, loss, grads

    @jax.jit
    def update_fn(p, state, grads, value):
        return optax.apply_updates(p, tx.update(grads, state, p, value=value)[0])

    port = phoscnet.PHOSCNet(hidden=32, trunk="vgg", dropout=0.0, dtype=torch.float32)
    named = dict(port.named_parameters())
    optimizer = make_optimizer(named.values(), lr, weight_decay=5e-5)
    plateau = ReduceOnPlateau(factor=0.25, patience=5 * epoch, cooldown=2 * epoch, atol=1e-4)
    gen = torch.Generator().manual_seed(0)
    state, value, order, scales = tx.init(params), 1e9, None, []
    for i in range(steps):
        if i % epoch == 0:
            value = -accs[i // epoch - 1] if i else 1e9
            order = np.random.default_rng(i).permutation(len(batches))
        x, tp, tc = batches[order[i % len(batches)]]
        adam = state[0][0]
        _load(port, jax.device_get(params))
        mu, nu = (state_dict_to_torch(jax_phoscnet_to_torch(jax.device_get(t)))
                  for t in (adam.mu, adam.nu))
        for k, p in named.items():
            # copies: the optimizer writes its moments in place, and a
            # tensor from device_get's array may share JAX's buffer
            optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                  "exp_avg": mu[k].clone(), "exp_avg_sq": nu[k].clone()}
        new, new_state, loss, grads = step_fn(params, state, x, tp, tc, jnp.float32(value))
        scales.append(float(new_state[1].scale))
        got = train_step(port, optimizer, torch.from_numpy(x), torch.from_numpy(tp),
                         torch.from_numpy(tc), gen, plateau, lr, value)
        assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss)), i
        assert float(plateau.scale) == scales[-1], i
        port_grads = torch_phoscnet_to_jax({k: p.grad for k, p in named.items()})
        want = jax.device_get(update_fn(params, state, port_grads, jnp.float32(value)))
        after = torch_phoscnet_to_jax(port.state_dict())
        g_all = jax.tree_util.tree_leaves(jax.device_get(grads))
        g_max = max(np.abs(g).max() for g in g_all)
        for a, b, g_port, g in zip(*(jax.tree_util.tree_leaves(t) for t in (
                after, want, port_grads)), g_all):
            assert np.abs(np.asarray(g_port) - g).max() <= 1e-3 * g_max, i
            a, b = np.asarray(a), np.asarray(b)
            assert (np.abs(a - b) <= 1e-3 * lr * scales[-1] + 2 * np.spacing(np.abs(b))).all(), i
        params, state = new, new_state
    assert sorted(set(scales)) == [0.0625, 0.25, 1.0]
