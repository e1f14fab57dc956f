"""Multi-device training and rendering over ``torch.distributed`` (PyTorch
port of ``gsplat_tpu/parallel``).

One process per device.  The JAX package runs one process over many
devices inside ``shard_map``; here each rank is its own process, a
``torch.distributed.device_mesh.DeviceMesh`` takes the place of the JAX
``Mesh`` (1-D ``("data",)`` or ``("tile",)``, 2-D ``("data", "tile")``), and
each ``psum``, ``pmean`` or ``pmax`` is a ``dist.all_reduce`` on that axis's
group: SUM, SUM then a division by the axis size, or MAX.  Every rank runs
the kernels K3, K1, K2 and K4 on its own camera or row slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One named axis of a mesh, as this rank sees it."""
    group: object        # the process group along the axis
    size: int
    index: int           # this rank's coordinate on the axis


def mesh_axis(mesh, name: str) -> Axis:
    return Axis(mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(
        name)), mesh.get_local_rank(name))


def make_mesh(shape, names, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the default group.

    A world of exactly ``prod(shape)`` ranks makes one mesh.  A larger world
    that ``prod(shape)`` divides splits into consecutive blocks, each its
    own mesh doing the same work (a replica); every rank gets its block's
    mesh.  The JAX package takes the first devices instead, which one
    process per device cannot do: every rank must join the mesh's
    groups."""
    if not dist.is_initialized():
        raise ValueError(f"a mesh of {math.prod(shape)} devices needs a "
                         "torch.distributed process group "
                         "(parallel.multihost.init_multihost)")
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    n = math.prod(shape)
    if n > world or world % n:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} "
                         f"devices, have {world}")
    ranks = torch.arange(world).reshape(world // n, *shape)
    full = DeviceMesh(torch.device(device).type, ranks,
                      mesh_dim_names=("replica", *names))
    return full[names if len(names) > 1 else names[0]]
