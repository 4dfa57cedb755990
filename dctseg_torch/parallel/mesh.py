"""The (data, space) mesh as process groups (the JAX package's
``dctseg/parallel/mesh.py``).

The JAX package runs one program over a device mesh: the batch is sharded
over ``data``, and on a 2-D mesh each sample's D axis over ``space``, with
GSPMD inserting the halo exchanges.  The port runs one process per GPU, so
the mesh is a set of ``torch.distributed`` groups: rank r sits at
(data index r // space, space index r % space); ``space`` consecutive ranks
form one space group (the ones nearest each other), and the ranks with the
same space index form one data group; ``group`` holds every rank (the int8
activation scale's MAX runs over it: one scale per conv call over the
whole logical tensor).  Groups of one rank are None: every collective of
``parallel/`` is then skipped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from dctseg_torch.parallel import distributed

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a (data, space) mesh and its groups."""
    data: int
    space: int
    rank: int
    data_group: Optional[object] = None    # same space index, all data
    space_group: Optional[object] = None   # same data index, all space
    group: Optional[object] = None         # every rank of the mesh

    @property
    def size(self) -> int:
        return self.data * self.space

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SPACE_AXIS: self.space}


def make_mesh(num_devices: Optional[int] = None, spatial: int = 1) -> Mesh:
    """The mesh over every process of the group (one process: a 1x1 mesh).
    ``num_devices`` is the world size, checked where given; ``spatial``
    consecutive ranks share a sample's D axis.  Every process must call it,
    in the same order as its other group constructions."""
    world = distributed.world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"--num-devices {num_devices} does not match the "
                         f"{world} processes of the group (one process per "
                         f"GPU)")
    if spatial < 1 or world % spatial:
        raise ValueError(f"{world} processes not divisible by "
                         f"spatial={spatial}")
    data, rank = world // spatial, distributed.rank()
    data_group = space_group = group = None
    if world > 1:
        # every rank constructs every group, in one order
        for s in range(spatial):
            g = dist.new_group(list(range(s, world, spatial)))
            if s == rank % spatial and data > 1:
                data_group = g
        for d in range(data):
            g = dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
            if d == rank // spatial and spatial > 1:
                space_group = g
        group = dist.new_group(list(range(world)))
    return Mesh(data, spatial, rank, data_group, space_group, group)


def data_size(mesh: Mesh) -> int:
    """Data-parallel shards (the global batch is the per-device batch times
    this)."""
    return mesh.data


def spatial_size(mesh: Mesh) -> int:
    return mesh.space


def batch_rows(mesh: Mesh, b: int) -> slice:
    """The rows of a b-row batch this process takes: a contiguous block of
    b / data rows where the batch divides (JAX's ``P('data')``), else all
    of them (the batch then runs whole on every data shard)."""
    if mesh.data > 1 and b % mesh.data == 0:
        per = b // mesh.data
        return slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    return slice(0, b)
