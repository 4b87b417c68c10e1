"""The port's profile_denoiser and roofline_dump tools on a small ``iam``
UNet (model_channels 32, 2 heads, B=2) on the CPU.

- ``model`` FLOPs (the plain path under ``FlopCounterMode``) equal a hand
  count of the UNet's convolutions and products from the shapes of its
  calls;
- ``as_run`` (every kernel site opaque, counted by the bound formulas) gives
  the same FLOPs for a call, exactly, since neither count has elementwise
  work in it; for a train step it gives ``model``'s plus the recomputed
  forwards of the Functions' backwards (B.3's ``h``, B.4, B.6), exactly;
  its kernel-site bytes are the sites' operands and outputs from their
  logged shapes;
- ``model`` FLOPs sit within 5% of XLA's ``cost_analysis()["flops"]`` for
  JAX's same call, jitted on the CPU. Measured: 206373888 against
  200933728, the port 2.7% above. The two differ by design: XLA counts only
  the taps of a padded convolution that land inside the image (a 3x3 conv
  at 8x32 has 10% of its taps in the padding, at 4x16 20%) and counts the
  elementwise work; ``FlopCounterMode`` counts every tap and no elementwise
  work;
- the bucket mapping, over a CPU ``torch.profiler`` trace of a call, puts
  every op under the UNet into exactly one bucket, each kernel site's ops
  into its kernel's bucket, and the buckets sum to the total; the device
  side's attribution (a kernel to its runtime call's ranges) on a
  hand-built event list.
"""

import collections
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from test_torch_copies import port_cfg
from worddiffusion_tpu.configs import presets as jpresets
from worddiffusion_tpu.models.unet import UNet as JaxUNet
from worddiffusion_tpu_torch.models import attention as mattention
from worddiffusion_tpu_torch.models import encoders
from worddiffusion_tpu_torch.models import layers
from worddiffusion_tpu_torch.ops import gn_conv
from worddiffusion_tpu_torch.scripts import profile_denoiser as pdn
from worddiffusion_tpu_torch.scripts import roofline_dump as rd

torch.set_num_threads(1)
B = 2
XLA_REL_TOL = 0.05


def _jax_exp():
    exp = jpresets.get("iam")
    return dataclasses.replace(exp, unet=dataclasses.replace(
        exp.unet, model_channels=32, num_heads=2, context_dim=32, dtype="float32"))


@pytest.fixture(scope="module")
def exp():
    return port_cfg(_jax_exp())


@pytest.fixture(scope="module")
def counts(exp):
    return rd.call_counts(b=B, exp=exp)


def hand_flops(exp) -> int:
    """2 multiply-adds per product term of every conv, dense layer, FF
    sub-layer and attention of one call, from the shapes of its calls."""
    model, inputs = pdn.flagship("cpu", b=B, exp=exp)
    total = 0

    def conv(m, args, out):
        nonlocal total
        total += 2 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]

    def dense(m, args, out):
        nonlocal total
        total += 2 * out.numel() * m.in_features

    def block(m, args, out):  # the FF sub-layer: x W1 [d, 2 inner], act W2 [inner, d]
        nonlocal total
        d, inner = m.ff.net[2].out_features, m.ff.net[2].in_features
        total += 2 * (out.numel() // d) * (d * 2 * inner + inner * d)

    def attn(m, args, out):  # q k^T and p v
        nonlocal total
        x, ctx = args[0], args[1] if len(args) > 1 and args[1] is not None else args[0]
        total += 2 * 2 * x.shape[0] * x.shape[1] * ctx.shape[1] * m.heads * m.dim_head

    def word(m, args, out):  # the character encoder's q k^T and p v
        nonlocal total
        b, n, h = args[0].shape
        total += 2 * 2 * b * n * n * h

    def b6(x, s, bias, w, cb, groups, eps):  # the fused conv's 3x3 taps
        nonlocal total
        total += 2 * x.numel() * 9 * w.shape[0]
        return plain_b6(x, s, bias, w, cb, groups, eps)

    plain_b6 = gn_conv.fused_gn_silu_conv3x3
    hooks = ((layers.Conv2D, conv), (layers.Dense, dense),
             (mattention.BasicTransformerBlock, block), (mattention.CrossAttention, attn),
             (encoders.WordAttention, word))
    handles = [m.register_forward_hook(fn) for m in model.modules()
               for cls, fn in hooks if isinstance(m, cls)]
    gn_conv.fused_gn_silu_conv3x3 = b6
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        gn_conv.fused_gn_silu_conv3x3 = plain_b6
        for h in handles:
            h.remove()
    return total


def test_model_flops_equal_a_hand_count(exp, counts):
    assert counts["model"]["flops"] == hand_flops(exp) > 0


def test_as_run_call_flops_equal_model_and_site_bytes_equal_their_shapes(counts):
    run = counts["as_run"]
    assert run["flops"] == counts["model"]["flops"]  # neither counts elementwise work
    by_site = collections.Counter(c["site"] for c in run["calls"])
    assert by_site == {"ln_geglu_ffn": 4, "attention": 8, "groupnorm": 9,
                       "gn_silu_conv3x3": 12}, by_site
    size = {"float32": 4, "bfloat16": 2}
    site_bytes = 0
    for c in run["calls"]:
        operands = sum(int(np.prod(s)) * size[d] for s, d in zip(c["shapes"], c["dtypes"]))
        x = int(np.prod(c["shapes"][0])) * size[c["dtypes"][0]]
        site_bytes += operands + x  # every forward site writes an x-shaped output
    assert run["kernel_site_bytes"] == site_bytes
    assert run["bytes_accessed"] == run["aten_bytes"] + site_bytes
    assert run["bytes_accessed"] < counts["model"]["bytes_accessed"]  # the fusions' savings
    attain = run["attainable"]
    assert attain["attainable_time_per_call_ms"] == pytest.approx(
        attain["aten_stream_ms"] + attain["kernel_sites_serial_ms"])


def test_train_step_as_run_adds_the_recomputed_forwards(exp):
    train = rd.train_counts(b=B, exp=exp)
    calls = train["as_run"]["calls"]
    by_site = collections.Counter(c["site"] for c in calls)
    assert by_site == {"ln_geglu_ffn": 4, "ln_geglu_ffn_bwd": 4, "attention": 8,
                       "groupnorm": 9, "gn_silu_conv3x3": 12}, by_site
    recompute = 0
    for c in calls:
        if c["site"] == "ln_geglu_ffn_bwd":  # B.3 recomputes h = LN(x) W1: 4 M d inner
            (m, d), inner = c["shapes"][0], c["shapes"][6][1]
            recompute += 4 * m * d * inner
        elif c["site"] in ("attention", "gn_silu_conv3x3"):  # the plain recompute
            recompute += c["flops"]
    assert train["as_run"]["flops"] - train["model"]["flops"] == recompute > 0
    for k in ("model", "as_run"):
        t = train[k]
        assert t["binding_resource"] == ("tensor" if t["tensor_bound_ms"] > t["hbm_bound_ms"]
                                         else "hbm")


def test_model_flops_beside_xla_cost_analysis(counts):
    jexp = _jax_exp()
    rng = np.random.default_rng(0)
    inp = (rng.standard_normal((B, 8, 32, 4)).astype(np.float32), np.full((B,), 100, np.int32),
           rng.integers(0, 53, (B, jexp.data.max_chars)).astype(np.int32),
           np.ones(B, np.int32))
    model = JaxUNet(jexp.unet)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    jax.eval_shape(model.init, jax.random.PRNGKey(0), *inp))
    ca = jax.jit(model.apply).lower(params, *inp).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    xla = float(ca["flops"])
    assert abs(counts["model"]["flops"] / xla - 1) <= XLA_REL_TOL, (counts["model"]["flops"], xla)


def test_bucket_mapping_puts_every_op_under_the_unet_in_one_bucket(exp):
    model, inputs = pdn.flagship("cpu", b=B, exp=exp)
    pdn.chained(model, inputs, 1)
    with pdn.layer_ranges(model), profile(activities=[ProfilerActivity.CPU]) as prof:
        pdn.chained(model, inputs, 1)
    events = prof.events()
    root = [e for e in events if e.name == pdn.LAYER + "unet (UNet)"]
    assert len(root) == 1
    start, end = root[0].time_range.start, root[0].time_range.end
    inside = [(pdn.layer_of(e), e.name, e.self_cpu_time_total) for e in events
              if e.device_type == DeviceType.CPU and start <= e.time_range.start < end
              and not e.name.startswith((pdn.LAYER, pdn.SITE))
              and not getattr(e, "is_user_annotation", False)]
    assert inside and all(layer for layer, _, _ in inside)
    buckets = {}
    for layer, op, _ in inside:
        got = [b for b in pdn.BUCKETS if pdn.bucket_of(layer, op) == b]
        assert len(got) == 1, (layer, op)
        buckets.setdefault(got[0], set()).add(layer.split(" (")[0])
    assert set(buckets) >= {"conv_3x3", "conv_1x1_skip_proj", "attention_inner", "ffn_kernel",
                            "groupnorm", "embed", "small_other"}, sorted(buckets)
    sites = {"ln_geglu_ffn": "ffn_kernel", "attention": "attention_inner",
             "groupnorm": "groupnorm", "gn_silu_conv3x3": "conv_3x3"}
    for layer, op, _ in inside:
        if "/" in layer:
            assert pdn.bucket_of(layer, op) == sites[layer.rsplit("/", 1)[1]], (layer, op)
    d = pdn.decompose(inside, 1)  # each op's self time: the buckets partition it
    assert d["device_leaf_total_ms_per_call"] == pytest.approx(
        sum(us for _, _, us in inside) / 1e3)
    assert sum(d["buckets_ms_per_call"].values()) == pytest.approx(
        d["device_leaf_total_ms_per_call"])


def _event(id_, name, device, start, end, parent=None):
    return types.SimpleNamespace(
        id=id_, name=name, device_type=device, cpu_parent=parent,
        time_range=types.SimpleNamespace(start=start, end=end,
                                         elapsed_us=lambda s=start, e=end: e - s))


def test_device_kernels_take_their_launch_calls_ranges():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    res = _event(1, pdn.LAYER + "input_blocks.1.0 (ResBlock)", cpu, 0, 100)
    site = _event(2, pdn.SITE + "gn_silu_conv3x3", cpu, 10, 20, res)
    launch_b6 = _event(900, "cudaLaunchKernelExC", cpu, 11, 12, site)
    skip = _event(3, pdn.LAYER + "input_blocks.1.0.skip_connection (Conv2D)", cpu, 30, 40, res)
    conv = _event(4, "aten::cudnn_convolution", cpu, 31, 39, skip)
    launch_conv = _event(901, "cudaLaunchKernel", cpu, 32, 33, conv)
    add = _event(5, "aten::add", cpu, 50, 60, res)
    launch_add = _event(902, "cudaLaunchKernel", cpu, 51, 52, add)
    events = [res, site, launch_b6, skip, conv, launch_conv, add, launch_add,
              _event(900, "gn_silu_conv3x3_kernel", cuda, 200, 230),
              _event(901, "sm90_xmma_fprop_kernel", cuda, 230, 240),
              _event(902, "vectorized_elementwise_kernel", cuda, 240, 242),
              _event(903, "direct_copy_kernel", cuda, 150, 160)]
    got = pdn.device_kernels(events, after_us=190)
    assert [(pdn.bucket_of(layer, op), us) for layer, op, us in got] == [
        ("conv_3x3", 30), ("conv_1x1_skip_proj", 10), ("small_other", 2)]
