"""Tensor parallelism over the model axis: what GSPMD inserts around
JAX's sharded matmuls, written out (Megatron-LM's layout).

A column-parallel layer (each rank its heads, or its slice of the FF's
inner width) takes a replicated input through ``copy_to_model``: identity
forward, the input's gradient summed over the model group backward, since
each rank's layer gives only its heads' share of it. A row-parallel layer
(``to_out.0``, the FF's ``net.2``) gives each rank a partial sum of the
output, which ``reduce_from_model`` sums over the group forward (identity
backward); the bias is added once, after the sum. ``gather_from_model``
joins shards forward and slices the gradient backward: its output is used
alike on every rank, so the full gradient is there already.

Each call moves all its tensors in one collective; sums are taken in fp32
whatever the activations' dtype. The collectives are ``all_reduce`` and
``all_gather``, which gloo takes on CUDA tensors too
(``parallel.distributed.SHARE_CARD_ENV``).

``shard_state_dict`` cuts a full UNet state dict for a rank by
``parallel.mesh.param_spec``; ``gather_state_dict`` (a collective over the
model group, each tensor joined by ``unshard``) joins the shards. Both are
exact: shards and joins round-trip bitwise.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, param_spec


def _all_reduce_fp32(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The fp32 sums over the model group of ``tensors`` (one collective)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.model_group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def _all_gather(tensors: Sequence[torch.Tensor], mesh: Mesh) -> list[list[torch.Tensor]]:
    """Every model rank's ``tensors`` (the same shapes and dtype on each),
    in rank order (one collective)."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"_all_gather takes tensors of one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(mesh.model)]
    dist.all_gather(parts, flat, group=mesh.model_group)
    out = []
    for p in parts:
        ts, i = [], 0
        for t in tensors:
            ts.append(p[i:i + t.numel()].view(t.shape))
            i += t.numel()
        out.append(ts)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # the same graph on every rank: the same gradients are None on each
        sums = iter(_all_reduce_fp32([g for g in grads if g is not None], ctx.mesh))
        return (None, *(None if g is None else next(sums).to(g.dtype) for g in grads))


def copy_to_model(mesh: Mesh, *xs: torch.Tensor):
    """``xs`` unchanged (a tuple, or the tensor itself for one); backward,
    each gradient summed over the model group."""
    out = _CopyToModel.apply(mesh, *xs)
    return out[0] if len(xs) == 1 else out


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.dtype = x.dtype
        return _all_reduce_fp32([x], mesh)[0]

    @staticmethod
    def backward(ctx, g):
        return None, g.to(ctx.dtype)


def reduce_from_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of the model ranks' partial ``x``, in fp32; backward, the
    gradient in x's dtype, unchanged."""
    return _ReduceFromModel.apply(mesh, x)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dims, *xs):
        ctx.mesh, ctx.dims = mesh, dims
        parts = _all_gather(xs, mesh)
        return tuple(torch.cat([p[i] for p in parts], dim=d) for i, d in enumerate(dims))

    @staticmethod
    def backward(ctx, *grads):
        m = ctx.mesh
        return (None, None, *(None if g is None else g.chunk(m.model, d)[m.model_rank]
                              for g, d in zip(grads, ctx.dims)))


def gather_from_model(mesh: Mesh, xs: Sequence[torch.Tensor], dims: Sequence[int]):
    """Each of ``xs`` joined along its ``dims`` entry over the model ranks
    (a tuple); backward, this rank's slice of each gradient."""
    return _GatherFromModel.apply(mesh, tuple(dims), *xs)


def shard(full: torch.Tensor, spec, model: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of ``full`` under ``spec`` (a contiguous copy;
    ``full`` itself where it is replicated)."""
    if spec is None or model == 1:
        return full
    if spec == "col":
        part = full.chunk(model, 0)[rank]
    elif spec == "row":
        part = full.chunk(model, 1)[rank]
    elif spec == "geglu_col":  # the rank's slice of each half, a then gate
        rest = full.shape[1:]
        part = full.reshape(2, model, -1, *rest)[:, rank].reshape(-1, *rest)
    else:
        raise ValueError(f"unknown layout {spec!r}")
    return part.clone(memory_format=torch.contiguous_format)


def unshard(parts: Sequence[torch.Tensor], spec) -> torch.Tensor:
    """The full tensor from every rank's shard, in rank order."""
    if spec is None:
        return parts[0]
    if spec == "col":
        return torch.cat(list(parts), 0)
    if spec == "row":
        return torch.cat(list(parts), 1)
    if spec == "geglu_col":
        rest = parts[0].shape[1:]
        halves = torch.stack([p.reshape(2, -1, *rest) for p in parts], 1)  # [2, M, n, ...]
        return halves.reshape(-1, *rest)
    raise ValueError(f"unknown layout {spec!r}")


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh: Mesh) -> dict:
    """This rank's UNet state dict from a full one (``param_spec``)."""
    return {k: shard(v, param_spec(k), mesh.model, mesh.model_rank) for k, v in full.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], mesh: Mesh,
                      spec=param_spec) -> dict:
    """The full state dict from this rank's, on every rank of the model
    group: a collective that each of them must call with the same keys.
    ``spec(key)`` gives each entry's layout (default ``param_spec``)."""
    out = dict(local)
    if mesh.model == 1:
        return out
    keys = [k for k in local if spec(k) is not None]
    for dtype in sorted({local[k].dtype for k in keys}, key=str):
        group = [k for k in keys if local[k].dtype == dtype]
        parts = _all_gather([local[k] for k in group], mesh)
        for i, k in enumerate(group):
            out[k] = unshard([p[i] for p in parts], spec(k))
    return out
