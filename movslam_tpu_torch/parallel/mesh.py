"""Process-group helpers: the port's counterpart of movslam_tpu/parallel/mesh.py.

The reference shards over a jax.sharding.Mesh inside one process; here each
rank is a process of an initialized torch.distributed group, holding its
own share of a leading axis. NCCL groups carry CUDA tensors, gloo groups
CPU tensors. The caller initializes the group and gives it its store or
address; nothing here picks a port or a backend. Without a group every
helper raises: nothing runs unsharded in its place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_or_world(group=None):
    """`group`, or the world group; raises when no group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("parallel/ needs an initialized torch.distributed process group "
                           "(dist.init_process_group(backend, store=..., rank=..., world_size=...))")
    return dist.group.WORLD if group is None else group


def rank(group=None):
    return dist.get_rank(group_or_world(group))


def world_size(group=None):
    return dist.get_world_size(group_or_world(group))


def check_device(x, group=None):
    """NCCL moves CUDA tensors, gloo CPU tensors; anything else raises."""
    backend = dist.get_backend(group_or_world(group))
    want = {"nccl": "cuda", "gloo": "cpu"}.get(backend)
    if want is not None and x.device.type != want:
        raise ValueError(f"a {backend} group needs {want} tensors, got {x.device}")


def shard_range(n, group=None):
    """This rank's contiguous share [lo, hi) of a leading axis of length n,
    which must split evenly over the group."""
    d, r = world_size(group), rank(group)
    if n % d:
        raise ValueError(f"a leading axis of {n} does not split over {d} ranks")
    step = n // d
    return r * step, (r + 1) * step


def all_gather_shards(x, group=None):
    """Concatenate every rank's equal-size shard along the leading axis, in
    rank order; every rank gets the whole array."""
    g = group_or_world(group)
    check_device(x, g)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x, group=g)
    return torch.cat(parts, dim=0)


def all_reduce_sum(x, group=None):
    """Sum x over the group in place and return it."""
    g = group_or_world(group)
    check_device(x, g)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
    return x
