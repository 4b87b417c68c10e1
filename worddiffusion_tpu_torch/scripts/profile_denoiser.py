"""Per-call time decomposition of the flagship denoiser on the card (the
port's counterpart of the JAX repo's ``scripts/profile_denoiser.py``).

The program is JAX's: the ``iam`` UNet at B=128 with its kernels (B.1,
B.4, B.5, B.6), x [128, 8, 32, 4] seeded normal (the port's UNet takes
latents NHWC, as JAX's does), t = 100, the context ``randint(0, 53)`` over
``max_chars``, writer 1, run as ``CALLS`` chained calls
``x <- x + 0.001 * eps`` (the UNet in its preset's bf16, as the sampler
runs it). CUDA events give ms per call, the best of 3 runs; then one
``torch.profiler`` pass gives each device kernel's time.

JAX maps each op to its layer through the HLO ``op_name`` metadata. Here
the tool does the same from outside the program: forward hooks open a
``record_function`` range per submodule (``<path> (<class>)``), and each
kernel site (the five helpers that launch B.1, B.3, B.4, B.5 or B.6 on a
CUDA tensor and run the plain version on a CPU tensor) is wrapped in a
range of its own. A device kernel belongs to the innermost ranges open on
the host when it was launched (its runtime call's parents), and
``bucket_of`` sorts it into JAX's buckets, with ``ffn_kernel`` for JAX's
``ffn_pallas`` (B.1 here) and ``groupnorm`` for B.5 (XLA fused the
statistics into the convs; here B.5 is a kernel of its own); B.6 is
``conv_3x3``. Every kernel lands in one bucket, so the buckets sum to the
device total.

    python -m worddiffusion_tpu_torch.scripts.profile_denoiser [--calls 50] \\
        [--out docs/torch_denoiser_time_decomposition.json]

It needs the card; the JSON carries its ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json
import re
import subprocess
from pathlib import Path
from unittest import mock

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

CALLS = 50  # denoiser calls in the chained program
B = 128
OUT = Path(__file__).resolve().parents[2] / "docs" / "torch_denoiser_time_decomposition.json"
BUCKETS = ("conv_3x3", "conv_1x1_skip_proj", "attention_inner", "ffn_kernel", "groupnorm",
           "embed", "copy", "small_other")
# The kernel sites: in each ops module, the helper that launches the kernel
# for a CUDA tensor and runs the plain version for a CPU tensor.
SITES = {
    "ln_geglu_ffn": ("ffn", "_sublayer"),            # B.1
    "ln_geglu_ffn_bwd": ("ffn", "_bwd_params"),      # B.3
    "attention": ("attention", "_attend"),           # B.4
    "groupnorm": ("groupnorm", "_groupnorm"),        # B.5
    "gn_silu_conv3x3": ("gn_conv", "_gn_conv"),      # B.6
}
# where each kernel's launches are counted (``ops.<module>.<counter>``)
COUNTERS = {"ln_geglu_ffn": ("ffn", "launches"), "attention": ("attention", "launches"),
            "groupnorm": ("groupnorm", "launches"), "gn_silu_conv3x3": ("gn_conv", "launches")}
LAYER = "layer:"
SITE = "site:"


def _ops(name: str):
    return importlib.import_module(f"worddiffusion_tpu_torch.ops.{name}")


@contextlib.contextmanager
def patched_sites(wrap):
    """Each kernel site's helper replaced by ``wrap(site, helper)`` for the
    duration (the program's code is not touched: the ops look their helpers
    up at call time)."""
    with contextlib.ExitStack() as stack:
        for site, (mod, attr) in SITES.items():
            m = _ops(mod)
            stack.enter_context(mock.patch.object(m, attr, wrap(site, getattr(m, attr))))
        yield


def _site_range(site: str, fn):
    def ranged(*args, **kwargs):
        with torch.profiler.record_function(SITE + site):
            return fn(*args, **kwargs)

    return ranged


@contextlib.contextmanager
def layer_ranges(model, root: str = "unet"):
    """A ``record_function`` range named ``layer:<path> (<class>)`` around
    every submodule's forward, and one ``site:<name>`` around every kernel
    site, while the block runs."""
    stack, handles = [], []

    def opener(label):
        def pre(module, args):
            rf = torch.profiler.record_function(LAYER + label)
            rf.__enter__()
            stack.append(rf)
        return pre

    def close(module, args, out):
        stack.pop().__exit__(None, None, None)

    for name, m in model.named_modules():
        label = f"{name or root} ({type(m).__name__})"
        handles += [m.register_forward_pre_hook(opener(label)), m.register_forward_hook(close)]
    try:
        with patched_sites(_site_range):
            yield
    finally:
        for h in handles:
            h.remove()


def bucket_of(layer: str, op: str) -> str:
    """The bucket of an op or kernel ``op`` run under ``layer`` (the
    innermost module's ``<path> (<class>)``, then ``/<site>`` inside a
    kernel site), in JAX's order: the kernels, convs, attention, copies,
    embeddings, the rest."""
    if "/ln_geglu_ffn" in layer:
        return "ffn_kernel"
    if "/gn_silu_conv3x3" in layer:
        return "conv_3x3"
    if "/groupnorm" in layer:
        return "groupnorm"
    if "(Conv2D)" in layer:
        if re.search(r"(skip_connection|proj_in|proj_out) \(", layer):
            return "conv_1x1_skip_proj"
        return "conv_3x3"
    if "/attention" in layer or re.search(r"\.attn[12][ .]|transformer_blocks", layer):
        return "attention_inner"
    if "copy" in op.lower():
        return "copy"
    if "emb" in layer:
        return "embed"
    return "small_other"


def layer_of(event) -> str:
    """The layer of a host event: its innermost ``layer:`` range among
    itself and its parents, and ``/<site>`` where a ``site:`` range lies
    inside that layer; "" outside every range."""
    layer, site = None, None
    e = event
    while e is not None and layer is None:
        if e.name.startswith(LAYER):
            layer = e.name[len(LAYER):]
        elif e.name.startswith(SITE) and site is None:
            site = e.name[len(SITE):]
        e = e.cpu_parent
    return (layer or "") + (f"/{site}" if site else "")


def device_kernels(events, after_us: float = float("-inf")):
    """(layer, kernel name, device us) of every device kernel, memset and
    copy that starts after ``after_us``: each belongs to the host runtime
    call that launched it (the same id), whose parents give its layer."""
    launches = {e.id: e for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    out = []
    for e in events:
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.time_range.start <= after_us):
            continue
        launch = launches.get(e.id)
        out.append((layer_of(launch) if launch is not None else "", e.name,
                    e.time_range.elapsed_us()))
    return out


def decompose(items, calls: int) -> dict:
    """Buckets and the 25 largest (layer, op) pairs, in ms per call."""
    agg, ops = collections.Counter(), collections.Counter()
    for layer, op, us in items:
        agg[bucket_of(layer, op)] += us
        ops[(layer, op)] += us
    total = sum(agg.values())
    return {
        "device_leaf_total_ms_per_call": total / 1e3 / calls,
        "buckets_ms_per_call": {k: v / 1e3 / calls for k, v in agg.most_common()},
        "top_ops_ms_per_call": [
            {"op": op[:120], "ms": us / 1e3 / calls, "layer": layer[:90],
             "bucket": bucket_of(layer, op)}
            for (layer, op), us in ops.most_common(25)
        ],
    }


def flagship(device: str, b: int = B, seed: int = 0, exp=None):
    """The ``iam`` UNet (seeded weights, eval; built in place and left
    unwritten on the meta device) on ``device`` and JAX's inputs for it:
    (model, (x, t, context, writer))."""
    from ..configs import presets
    from ..models.layers import init_weights_, skip_default_init
    from ..models.unet import UNet

    exp = exp or presets.get("iam")
    meta = torch.device(device).type == "meta"
    with skip_default_init(), torch.device("meta" if meta else "cpu"):
        model = UNet(exp.unet)
    if not meta:
        init_weights_(model, seed=seed)
    model = model.to(device).eval()
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, exp.data.img_height // 8, exp.data.img_width // 8,
                    exp.unet.in_channels, generator=g)
    ctx = torch.randint(0, 53, (b, exp.data.max_chars), generator=g)
    inputs = (x, torch.full((b,), 100), ctx, torch.ones(b, dtype=torch.long))
    return model, tuple(a.to(device) for a in inputs)


def chained(model, inputs, calls: int):
    """``calls`` denoiser calls, each on the last one's ``x + 0.001 eps``."""
    x, rest = inputs[0], inputs[1:]
    with torch.no_grad():
        for _ in range(calls):
            x = x + 0.001 * model(x, *rest)
    return x


def launch_counts() -> dict:
    return {k: getattr(_ops(m), c) for k, (m, c) in COUNTERS.items()}


def profile(model, inputs, calls: int = CALLS) -> dict:
    """On the card: ms per call (CUDA events, best of 3 chained runs), the
    profiled pass's device kernels by bucket and by (layer, kernel), and
    each kernel's launches per call."""
    chained(model, inputs, 2)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chained(model, inputs, calls)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    before = launch_counts()
    with layer_ranges(model), torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler may miss the first kernels of its window: one call
        # takes that loss, and a marker kernel parts it from the counted ones
        chained(model, inputs, 1)
        torch.cuda.synchronize()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        chained(model, inputs, calls)
        torch.cuda.synchronize()
    after = launch_counts()
    events = prof.events()
    marks = [e for e in events if "spin_kernel" in e.name and e.device_type == DeviceType.CUDA]
    if len(marks) != 1:
        raise RuntimeError(f"{len(marks)} marker kernels profiled")
    items = device_kernels(events, after_us=marks[0].time_range.end)
    return {
        "measured_ms_per_call": best / calls,
        **decompose(items, calls),
        "kernels_per_call": len(items) / calls,
        "launches_per_call": {k: (after[k] - before[k]) / (calls + 1) for k in after},
    }


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=CALLS)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_denoiser needs the card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model, inputs = flagship("cuda")
    result = {
        "program": f"{args.calls} chained flagship denoiser calls, B={B}, iam preset, kernels "
                   "B.1/B.4/B.5/B.6 on",
        **profile(model, inputs, args.calls),
        "device": smi(),
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result[k] for k in ("measured_ms_per_call",
                                             "device_leaf_total_ms_per_call",
                                             "buckets_ms_per_call", "launches_per_call",
                                             "device")}, indent=1))
    return result


if __name__ == "__main__":
    main()
