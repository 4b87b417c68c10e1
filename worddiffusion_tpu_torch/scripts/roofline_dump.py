"""The flagship denoiser call's and the train step's work and bound on the
card (the port's counterpart of the JAX repo's ``scripts/roofline_dump.py``).

The programs are JAX's: one ``iam`` UNet call at B=128 on
``profile_denoiser``'s inputs, and the train step at B=128 as
``train/step`` runs it (q_sample, the UNet forward and backward, MSE,
AdamW, EMA). PyTorch has no XLA cost analysis, so the tool counts the work
itself, on the meta device (no card, no data):

- ``model``, the function's work whatever implements it: the plain path
  (every kernel site runs its plain version). ``FlopCounterMode`` counts the
  products and convolutions; ``ByteCounter`` adds each aten op's input and
  output bytes (views move none), every op's traffic visible, as XLA's
  ``bytes accessed`` of JAX's unfused program.
- ``as_run``, the path as the card runs it: the aten ops around the kernels
  are counted as in ``model`` (the weight casts, the recomputing backwards
  of B.4, B.5 and B.6), while each kernel site (B.1, B.3, B.4, B.5, B.6) is
  opaque to both counters, as a ``pallas_call`` is to XLA, and is counted
  from the shapes of its call with the formulas of ``chip_smoke.py``'s
  bound column: its operands and outputs read and written once, and
  ``6 M d inner`` (B.1), ``16 M d inner`` (B.3), ``4 b h nq nk d`` (B.4),
  0 (B.5) and ``18 c² b h w`` (B.6) operations. The tool logs every site
  call from outside the program, as JAX's ``ffn_pallas.record_ffn_calls``
  does.

Bounds use the published H100 SXM rates (3.35 TB/s, 989 TFLOP/s bf16):
``memory_bound_time_per_call_ms`` = bytes / rate, the 999-call DDPM
roofline ``B / (999 bytes / rate)``; ``attainable`` charges each kernel
site its own bound, serial with the aten ops' stream, as JAX's
'attainable' charges the kernel's matmul floor.

    python -m worddiffusion_tpu_torch.scripts.roofline_dump \\
        [--out docs/torch_roofline_cost_analysis.json]

On the card the JSON carries its ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .profile_denoiser import B, _ops, flagship, patched_sites, smi

OUT = Path(__file__).resolve().parents[2] / "docs" / "torch_roofline_cost_analysis.json"
# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit),
# the same constants as chip_smoke.py's
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
DDPM_CALLS = 999


def _touched(t) -> int:
    """Bytes a tensor's elements span: a broadcast (zero-stride) axis once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tensor_bytes(*tensors) -> int:
    return sum(_touched(t) for t in _tensors(tensors))


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class ByteCounter(TorchDispatchMode):
    """Adds up every aten op's input and output bytes in ``.bytes``: views,
    allocations and metadata move none, and an op that only writes its
    first argument (``copy_``, ``fill_``, ``zero_``) does not read it."""

    aten = torch.ops.aten
    FREE = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
            aten.new_empty.default, aten.new_empty_strided.default, aten.detach.default,
            aten.lift_fresh.default, aten._local_scalar_dense.default, aten.resize_.default}
    WRITE_ONLY = {aten.copy_.default, aten.fill_.Scalar, aten.fill_.Tensor, aten.zero_.default}

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in self.FREE or _is_view(func):
            return out
        read = args[1:] if func in self.WRITE_ONLY else args
        self.bytes += tensor_bytes(read, kwargs) + tensor_bytes(out)
        return out


@contextlib.contextmanager
def counting():
    """``FlopCounterMode`` and ``ByteCounter`` over the block; yields a
    callable giving (flops, bytes) so far."""
    flops = FlopCounterMode(display=False)
    with flops, ByteCounter() as nbytes:
        yield lambda: (flops.get_total_flops(), nbytes.bytes)


@contextlib.contextmanager
def plain_path():
    """Every kernel entry point through its plain version under plain
    autograd (the FF as ``use_pallas_ffn=False`` runs it), as
    ``chip_smoke.all_plain`` runs the UNet: no Function, no recompute."""
    ffn, attention, groupnorm, gn_conv = (_ops(m) for m in ("ffn", "attention", "groupnorm",
                                                             "gn_conv"))

    def sublayer(x, gamma, beta, w1, b1, w2, b2, eps=1e-5):
        return ffn.ln_geglu_ffn_reference(x, gamma, beta, w1.t(), b1, w2.t(), b2, eps)

    with mock.patch.object(ffn, "ffn_sublayer", sublayer), \
            mock.patch.object(attention, "fused_attention", attention.attention_reference), \
            mock.patch.object(groupnorm, "fused_groupnorm", groupnorm.groupnorm_reference), \
            mock.patch.object(gn_conv, "fused_gn_silu_conv3x3",
                              gn_conv.gn_silu_conv3x3_reference):
        yield


def _as_run(log: list):
    """Kernel sites as the card runs them: the aten ops its CUDA branch runs
    before the launch (counted), then the launch itself, opaque: empty
    outputs, and its operands, outputs and operations appended to ``log``."""
    ffn, gn_conv = _ops("ffn"), _ops("gn_conv")
    bf16 = torch.bfloat16

    def record(site, operands, outs, flops):
        outs = outs if isinstance(outs, tuple) else (outs,)
        log.append({"site": site,
                    "shapes": [list(t.shape) for t in _tensors(operands)],
                    "dtypes": [str(t.dtype).replace("torch.", "") for t in _tensors(operands)],
                    "bytes": tensor_bytes(operands, outs), "flops": flops})
        return outs if len(outs) > 1 else outs[0]

    def sublayer(x, gamma, beta, w1, b1, w2, b2, eps):
        w1k, w2k = ffn._contiguous_as(w1, bf16), ffn._contiguous_as(w2, bf16)
        d, inner = x.shape[-1], w2k.shape[1]
        return record("ln_geglu_ffn", (x, gamma, beta, w1k, b1, w2k, b2), torch.empty_like(x),
                      6 * (x.numel() // d) * d * inner)

    def bwd_params(x, dy, gamma, beta, w1, b1, w2, eps):
        (m, d), inner = x.shape, w2.shape[1]
        f32 = dict(dtype=torch.float32, device=x.device)
        outs = (torch.empty_like(x), torch.empty(d, **f32), torch.empty(d, **f32),
                torch.empty(2 * inner, d, **f32), torch.empty(2 * inner, **f32),
                torch.empty(d, inner, **f32), torch.empty(d, **f32))
        return record("ln_geglu_ffn_bwd", (x, dy, gamma, beta, w1, b1, w2), outs,
                      16 * m * d * inner)

    def attend(q, k, v, scale, fast):
        b, h, nq, d = q.shape
        return record("attention", (q, k, v), torch.empty_like(q), 4 * b * h * nq * k.shape[2] * d)

    def norm(x, scale, bias, groups, eps, silu):
        return record("groupnorm", (x, scale, bias), torch.empty_like(x), 0)

    def gn_silu_conv(x, gn_scale, gn_bias, w, b, groups, eps):
        wk = gn_conv.kernel_weight(w)
        c = x.shape[-1]
        return record("gn_silu_conv3x3", (x, gn_scale, gn_bias, wk, b), torch.empty_like(x),
                      18 * c * c * (x.numel() // c))

    sites = {"ln_geglu_ffn": sublayer, "ln_geglu_ffn_bwd": bwd_params, "attention": attend,
             "groupnorm": norm, "gn_silu_conv3x3": gn_silu_conv}
    return lambda site, helper: sites[site]


def bound_ms(n_bytes: float, flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3


def count(fn, as_run: bool) -> dict:
    """``fn()``'s flops and bytes with the kernel sites plain (``model``) or
    as the card runs them (``as_run``: the sites' own counts added, and each
    site call in ``calls``)."""
    log = []
    with (patched_sites(_as_run(log)) if as_run else plain_path()), counting() as totals:
        fn()
        flops, n_bytes = totals()
    out = {"aten_flops": flops, "aten_bytes": n_bytes}
    if as_run:
        site_flops = sum(c["flops"] for c in log)
        site_bytes = sum(c["bytes"] for c in log)
        out.update(kernel_site_flops=site_flops, kernel_site_bytes=site_bytes,
                   kernel_site_bound_ms=sum(bound_ms(c["bytes"], c["flops"]) for c in log),
                   calls=log)
        flops, n_bytes = flops + site_flops, n_bytes + site_bytes
    return {"flops": flops, "bytes_accessed": n_bytes, **out}


def call_counts(b: int = B, exp=None) -> dict:
    """``model`` and ``as_run`` of one UNet call at batch ``b``."""
    model, inputs = flagship("meta", b=b, exp=exp)

    def call():
        with torch.no_grad():
            model(*inputs)

    out = {}
    for name, as_run in (("model", False), ("as_run", True)):
        c = count(call, as_run)
        n_bytes = c["bytes_accessed"]
        c.update(gflop_per_image=c["flops"] / b / 1e9, gb_per_call=n_bytes / 1e9,
                 memory_bound_time_per_call_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
                 tensor_bound_time_per_call_ms=c["flops"] / BF16_FLOP_PER_S * 1e3,
                 full_ddpm_roofline_imgs_per_s=b / (DDPM_CALLS * n_bytes / HBM_BYTES_PER_S))
        out[name] = c
    run = out["as_run"]
    aten_ms = bound_ms(run["aten_bytes"], run["aten_flops"])
    attain = aten_ms + run["kernel_site_bound_ms"]
    run["attainable"] = {
        "aten_stream_ms": aten_ms, "kernel_sites_serial_ms": run["kernel_site_bound_ms"],
        "attainable_time_per_call_ms": attain,
        "attainable_full_ddpm_imgs_per_s": b / (DDPM_CALLS * attain / 1e3),
    }
    return out


def train_counts(b: int = B, exp=None) -> dict:
    """``model`` and ``as_run`` of one train step at batch ``b`` (the EMA
    past its warm-up, as in steady training)."""
    from ..configs import presets
    from ..diffusion.schedule import NoiseSchedule
    from ..train.state import TrainState, make_optimizer
    from ..train.step import StepDraws, make_train_step

    exp = exp or presets.get("iam")
    out = {}
    for name, as_run in (("model", False), ("as_run", True)):
        model, (x, _, ctx, wid) = flagship("meta", b=b, exp=exp)
        model.train()
        state = TrainState.create(model, make_optimizer(model.parameters(), exp.train.lr))
        state.step = exp.train.ema_warmup_steps
        sched = NoiseSchedule.linear(exp.diffusion.num_steps, exp.diffusion.beta_start,
                                     exp.diffusion.beta_end)
        step = make_train_step(sched, exp)
        batch = {"latent": x, "context": ctx, "writer": wid}
        draws = StepDraws(torch.full((b,), 100, device="meta"), torch.empty_like(x),
                          torch.ones((), device="meta") if exp.train.cfg_drop_prob > 0 else None)
        c = count(lambda: step(state, batch, draws), as_run)
        tensor_ms = c["flops"] / BF16_FLOP_PER_S * 1e3
        hbm_ms = c["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
        c.update(tensor_bound_ms=tensor_ms, hbm_bound_ms=hbm_ms,
                 binding_resource="tensor" if tensor_ms > hbm_ms else "hbm")
        out[name] = c
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    call = call_counts()
    train = train_counts()
    result = {
        "program": f"flagship iam denoiser forward, B={B} (one DDPM call), and the train step "
                   f"at B={B}",
        "hbm_bw_assumed_gbps": HBM_BYTES_PER_S / 1e9,
        "bf16_peak_assumed_tflops": BF16_FLOP_PER_S / 1e12,
        "derivation": "imgs/s <= B / (999 calls * bytes_accessed / HBM_BW)",
        "model": {"note": "plain path: every op's traffic visible (JAX's xla_only)",
                  **call["model"]},
        "as_run": {"note": "the card's path: the kernel sites (B.1, B.4, B.5, B.6) opaque to "
                           "the counters, counted from their calls' shapes",
                   **call["as_run"]},
        "train_step": {
            "program": f"train step fwd+bwd, B={B} (q_sample + UNet fwd/bwd + MSE + AdamW + "
                       "EMA), as train/step runs it",
            "tensor_peak_assumed_tflops": BF16_FLOP_PER_S / 1e12,
            "model": {k: v for k, v in train["model"].items() if k != "calls"},
            "as_run": {k: v for k, v in train["as_run"].items() if k != "calls"},
        },
        "device": smi() if torch.cuda.is_available() else "no card: counted on the host",
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "calls"}
                      if isinstance(v, dict) else v for k, v in result.items()}, indent=1))
    return result


if __name__ == "__main__":
    main()
