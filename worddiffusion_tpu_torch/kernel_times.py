"""Time the attention kernel (B.4) and the GN -> SiLU -> conv3x3 kernel (B.6)
of two source trees on one card, by three methods, and read what holds B.4
back against ``scaled_dot_product_attention``.

    python3 worddiffusion_tpu_torch/kernel_times.py --other DIR [--out FILE]

DIR is another checkout of the repo, or just its ``worddiffusion_tpu_torch``
package, for example an earlier commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists. Each tree runs in a process of its own,
in the order other, this, this, other, so that a drift of the card shows as a
difference between the two runs of one tree; each process builds its own
tree's kernels. At every shape it times the kernel's op and its library
yardstick (SDPA; ``F.group_norm`` -> ``F.silu`` -> cuDNN ``F.conv2d``):

- ``single_ms``: one call between two CUDA events, the median of 30; the
  host's launch path adds to it where it is longer than the device work;
- ``launch_ms``: per call over 10 calls back to back between two events, the
  median of 10 (``chip_smoke.py``'s method): the launch path overlaps;
- ``kernel_ms``: the device time of the call's kernels alone, from
  ``torch.profiler``, per call over 10 calls.

Then, in this tree only: the registers, stack, local (spilled) and static
shared memory of each attention kernel instance as ``cuobjdump
-res-usage`` reads them from the built library, the CTAs per SM those and
the dynamic shared memory allow, and B.4 against SDPA over Nk at B=128,
Nq=256 (``kernel_ms``), fitted as a fixed cost plus a cost per 64-key chunk.

Prints one JSON object a process and a summary; writes everything to
FILE (default ``build/kernel_times.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

HEADS, D_HEAD = 4, 80
# (B, Nq, Nk): every B=128 attention of the training step, and the iam
# regeneration's widest
ATTN_SHAPES = ((128, 256, 811), (128, 64, 811), (128, 256, 256), (128, 64, 64),
               (128, 256, 42), (128, 64, 42), (16, 256, 42))
# (B, H, W, C): every B=128 B.6 site (UNet and VAE encoder), and the UNet's and
# the decoder's widest at B=16
CONV_SHAPES = ((128, 8, 32, 320), (128, 4, 16, 320), (128, 16, 64, 512), (128, 8, 32, 512),
               (128, 32, 128, 256), (128, 64, 256, 128), (16, 8, 32, 320), (16, 64, 256, 128))
SWEEP_NK = (64, 256, 512, 811, 1024, 2048)


def single_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_ms(fn, calls: int = 10, reps: int = 10) -> float:
    return single_ms(lambda: [fn() for _ in range(calls)], reps=reps, warmup=1) / calls


def kernel_ms(fn, calls: int = 10) -> tuple[float, list[str]]:
    """Device time per call of the kernels ``fn`` launches, and their names.
    A trace that caught no kernel event (seen now and then on the card) is
    taken again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            names = sorted({e.name[:80] for e in kernels})
            return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls, names
    raise RuntimeError("torch.profiler caught no kernel in three traces")


def three_ways(fn) -> dict:
    k, names = kernel_ms(fn)
    return dict(single_ms=single_ms(fn), launch_ms=launch_ms(fn), kernel_ms=k, kernels=names)


def attn_inputs(b: int, nq: int, nk: int, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(b, HEADS, n, D_HEAD, generator=g).bfloat16().cuda()
                 for n in (nq, nk, nk))


def conv_inputs(b: int, h: int, w: int, c: int, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(b, h, w, c, generator=g) + 0.5).bfloat16().cuda()
    scale = (1 + 0.1 * torch.randn(c, generator=g)).cuda()
    bias = (0.1 * torch.randn(c, generator=g)).cuda()
    wt = (torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5).cuda()
    cb = (0.1 * torch.randn(c, generator=g)).cuda()
    return x, scale, bias, wt, cb


def worker(tree: str, deep: bool) -> dict:
    """Every time of one tree's kernels; with ``deep``, the resource use and
    the Nk sweep too."""
    import torch
    import torch.nn.functional as F

    from worddiffusion_tpu_torch.ops import attention, build, gn_conv

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    lib = build.build()
    scale = D_HEAD ** -0.5
    out = dict(tree=tree, attention=[], conv=[])
    for i, (b, nq, nk) in enumerate(ATTN_SHAPES):
        q, k, v = attn_inputs(b, nq, nk, seed=30 + i)
        out["attention"].append(dict(
            shape=[b, nq, nk], kernel=three_ways(lambda: attention.fused_attention(q, k, v, scale)),
            library=three_ways(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))))
    for i, (b, h, w, c) in enumerate(CONV_SHAPES):
        x, s, bi, wt, cb = conv_inputs(b, h, w, c, seed=120 + i)
        nchw, ws, bs = x.permute(0, 3, 1, 2), s.bfloat16(), bi.bfloat16()
        wb, cbb = wt.bfloat16().contiguous(memory_format=torch.channels_last), cb.bfloat16()
        out["conv"].append(dict(
            shape=[b, h, w, c],
            kernel=three_ways(lambda: gn_conv.fused_gn_silu_conv3x3(x, s, bi, wt, cb, 32, 1e-6)),
            library=three_ways(lambda: F.conv2d(F.silu(F.group_norm(nchw, 32, ws, bs, 1e-6)),
                                                wb, cbb, padding=1))))
        del x, nchw
    if deep:
        out["resources"] = resources(str(lib))
        out["sweep"] = sweep(attention, scale)
    return out


def resources(lib: str) -> list[dict]:
    """``cuobjdump -res-usage`` of each attention kernel instance at D=80,
    and the CTAs per SM its registers and shared memory allow (65536
    registers a SM, allocated per warp in units of 256; 228 KB of shared
    memory a SM, 1 KB of it reserved per CTA; at most 2048 threads)."""
    cuobjdump = os.path.join(os.path.dirname(os.path.dirname(build_nvcc())), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True, text=True,
                          check=True).stdout
    rows = []
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"attention_kernelILi80ELi(\d+)ELi(\d+)E", line)
        if not m or "Function" not in line or i + 1 >= len(lines):
            continue
        usage = dict((k, int(v)) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)",
                                                        lines[i + 1]))
        warps, mt = int(m.group(1)), int(m.group(2))
        bq = 16 * mt * warps
        dyn = (bq + 2 * 2 * 64) * (D_HEAD + 8) * 2  # q tile + 2 stages of k and v chunks
        per_warp = -(-usage["REG"] * 32 // 256) * 256
        ctas = min(65536 // (per_warp * warps), (228 * 1024) // (dyn + usage["SHARED"] + 1024),
                   2048 // (32 * warps), 32)
        rows.append(dict(warps=warps, m_tiles=mt, query_rows=bq, dynamic_shared=dyn,
                         ctas_per_sm=ctas, warps_per_sm=ctas * warps, **usage,
                         raw=lines[i + 1].strip()))
    return rows


def build_nvcc() -> str:
    from worddiffusion_tpu_torch.ops import build

    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    return nvcc


def sweep(attention, scale: float) -> dict:
    """B.4 and SDPA device time over Nk at B=128, Nq=256, and a least-squares
    line through each: fixed ms + ms per 64-key chunk."""
    import torch.nn.functional as F

    rows = []
    for i, nk in enumerate(SWEEP_NK):
        q, k, v = attn_inputs(128, 256, nk, seed=200 + i)
        rows.append(dict(nk=nk, kernel_ms=kernel_ms(
            lambda: attention.fused_attention(q, k, v, scale))[0], library_ms=kernel_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))[0]))
    chunks = [-(-r["nk"] // 64) for r in rows]
    fit = {}
    for key in ("kernel_ms", "library_ms"):
        slope, intercept = statistics.linear_regression(chunks, [r[key] for r in rows])
        fit[key] = dict(fixed_ms=intercept, ms_per_chunk=slope)
    return dict(rows=rows, fit=fit)


def run_tree(tree: str, deep: bool) -> dict:
    """One worker process on ``tree``'s package."""
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", os.path.abspath(tree)]
    if deep:
        cmd.append("--deep")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"worker on {tree} failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def summary(runs: list[dict]) -> list[str]:
    """Per shape and method: each tree's time (mean of its two runs), the
    library's, and other / this."""
    lines = []
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).append(r)
    (other, o_runs), (this, t_runs) = by_tree.items()
    for kind in ("attention", "conv"):
        for j, row in enumerate(t_runs[0][kind]):
            parts = []
            for method in ("single_ms", "launch_ms", "kernel_ms"):
                t = statistics.mean(r[kind][j]["kernel"][method] for r in t_runs)
                o = statistics.mean(r[kind][j]["kernel"][method] for r in o_runs)
                lib = statistics.mean(r[kind][j]["library"][method] for r in t_runs)
                parts.append(f"{method} this {t:.4f} other {o:.4f} ({o / t:.2f}x) library "
                             f"{lib:.4f}")
            lines.append(f"{kind} {row['shape']}: " + "; ".join(parts))
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", help="another tree: its worddiffusion_tpu_torch is timed too")
    p.add_argument("--out", default="build/kernel_times.json")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    p.add_argument("--deep", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.deep)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.other:
        order = [(args.other, False), (here, True), (here, False), (args.other, False)]
    else:
        order = [(here, True)]
    runs = [run_tree(tree, deep) for tree, deep in order]
    result = dict(device=smi, runs=runs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    deep = next(r for r in runs if "resources" in r)
    for r in deep["resources"]:
        print("attention resources", json.dumps(r))
    print("attention Nk sweep", json.dumps(deep["sweep"]))
    if args.other:
        for line in summary(runs):
            print(line)
    return 0


if __name__ == "__main__":
    if "--worker" in sys.argv:
        # the tree under test first on the path, in place of this file's
        # directory, so that its own package is the one imported
        sys.path[0] = sys.argv[sys.argv.index("--worker") + 1]
    sys.exit(main())
