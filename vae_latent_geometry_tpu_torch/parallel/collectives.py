"""Collectives over a mesh axis: the counterpart of ``jax.lax.psum``.

:func:`psum` is differentiable, and its backward is an all-reduce of the
cotangent: JAX's untyped transpose of ``psum`` under
``shard_map(check_vma=False)``, which the decoder-sharded energy's gradient
contract is written for (``ops/energy_fused.energy_expected_sharded``).  A
``group`` of None stands for a mesh axis of size 1: nothing to reduce.

NCCL groups reduce CUDA tensors in place on the device; a gloo group (CPU
runs, or several ranks on one card) stages a CUDA tensor through host
memory.
"""

from __future__ import annotations

import torch


def _on_wire(x: torch.Tensor, group):
    """(buffer the backend can reduce, whether it is a host copy)."""
    import torch.distributed as dist

    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu(), True
    return x, False


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group``, as a new tensor (no
    autograd).  Every rank receives the same bits."""
    if group is None:
        return x
    import torch.distributed as dist

    out = x.detach().clone().contiguous()
    buf, staged = _on_wire(out, group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if staged:
        out.copy_(buf)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce_sum(ct, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the ranks of ``group``; its backward sums the
    cotangents over the same ranks."""
    if group is None:
        return x
    return _PSum.apply(x, group)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``, as a new
    tensor (no autograd)."""
    if group is None:
        return x
    import torch.distributed as dist

    out = x.detach().clone().contiguous()
    buf, staged = _on_wire(out, group)
    dist.broadcast(buf, src=src, group=group)
    if staged:
        out.copy_(buf)
    return out


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equally-shaped ``x`` concatenated along axis 0 in rank
    order, on every rank (no autograd)."""
    if group is None:
        return x
    import torch.distributed as dist

    buf, staged = _on_wire(x.detach().contiguous(), group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(x.device) if staged else out
