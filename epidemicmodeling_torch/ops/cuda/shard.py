"""Lane sharding of the EKS kernels over a device mesh.

Counterpart of epidemicmodeling_tpu/ops/pallas/shard.py. A kernel launch is
a single-device program, so a mesh run blocks the lane (last) axis of every
argument over the mesh's slots, runs the kernel (or its plain version, on
CPU slots) per slot on its own block, and gathers the outputs back. Lanes
are independent filters: the only communication is that gather. Used (through
map_lanes) by ekf3_kernel.ekf3_lanes and pipelines/core's sweep, so the
split and the axis-order rule live in one place.
"""

from __future__ import annotations

import numpy as np
import torch

from ...parallel.mesh import block_index


def pad_for_mesh(B: int, mesh) -> tuple[int, int]:
    """(n_dev, pad): the lanes to add so that B + pad splits into n_dev
    equal blocks, one a slot. The port's kernels take any B and mask their
    ragged edge, so the pad is only to a multiple of the slot count (the
    JAX package pads to its TPU kernels' 128 / 1024-lane tiles per
    device)."""
    n_dev = 1 if mesh is None else mesh.size
    return n_dev, (-B) % n_dev


def pad_lanes(pad: int):
    """The lane-padding transform paired with pad_for_mesh: replicate lane 0
    into ``pad`` extra trailing lanes."""
    if pad == 0:
        return lambda a: a
    return lambda a: torch.cat(
        [a, a[..., :1].expand(a.shape[:-1] + (pad,))], dim=-1)


def _lane_owners(mesh, axis_order):
    """{block k: (slot, owning process)} for the lane axis split over
    ``axis_order``."""
    out = {}
    for slot in np.ndindex(mesh.devices.shape):
        k, _ = block_index(mesh, slot, axis_order)
        out[k] = (slot, int(mesh.process_index[slot]))
    return out


def shard_lanes(run, mesh, args, axis_order, n_out: int):
    """Run ``run(*args)`` with the lane (last) axis of every arg split over
    the mesh, and return its ``n_out`` outputs gathered along their last
    axis on the lead slot.

    The lanes are split into mesh.size contiguous blocks; block k goes to
    the slot that a JAX PartitionSpec(..., axis_order) gives block k: for
    ("ep", "dp"), block e * dp + d to the slot (d, e). axis_order is
    ("ep", "dp") for epsilon-major lanes (the Pareto sweep's lane e * R +
    r), ("dp", "ep") for region-major ones. Any balanced split is
    semantically right (the lanes are independent); the order only decides
    which lanes land on which device. Every local slot's block is launched
    before any result is read; across processes the outputs are joined by
    an all_gather on the mesh's group (through the host when that group is
    Gloo's)."""
    B = args[0].shape[-1]
    n = mesh.size
    if any(a.shape[-1] != B for a in args) or B % n:
        raise ValueError(f"lanes {[a.shape[-1] for a in args]} do not split "
                         f"into {n} equal blocks (pad with pad_for_mesh)")
    b = B // n
    owners = _lane_owners(mesh, axis_order)
    blocks = {}
    for k in sorted(owners):
        slot, rank = owners[k]
        if rank != mesh.rank:
            continue
        dev = mesh.devices[slot]
        outs = tuple(run(*(a[..., k * b:(k + 1) * b].to(dev).contiguous()
                           for a in args)))
        if len(outs) != n_out:
            raise ValueError(f"run returned {len(outs)} outputs, expected "
                             f"{n_out}")
        blocks[k] = outs
    if mesh.spans_processes:
        blocks = _all_gather_blocks(mesh, owners, blocks, n_out, b)
    lead = mesh.lead
    return tuple(torch.cat([blocks[k][j].to(lead) for k in range(n)], dim=-1)
                 for j in range(n_out))


def map_lanes(run, mesh, args, axis_order, n_out: int):
    """``run(*args)``; on a mesh of several slots, with the lanes padded to a
    multiple of the slot count (pad_for_mesh, pad_lanes), split over the
    slots (shard_lanes) and the pad cut off the gathered outputs."""
    if mesh is None or mesh.size == 1:
        return tuple(run(*args))
    B = args[0].shape[-1]
    _, pad = pad_for_mesh(B, mesh)
    outs = shard_lanes(run, mesh, [pad_lanes(pad)(a) for a in args],
                       axis_order, n_out)
    return tuple(o[..., :B] for o in outs)


def _all_gather_blocks(mesh, owners, blocks, n_out, b):
    """Every process's blocks, from the blocks this process computed: one
    all_gather an output, each process contributing its blocks in block
    order. A process's blocks lie on its own slots' devices, which may be
    several cards: they are joined on the lead slot."""
    import torch.distributed as dist

    via_host = dist.get_backend(mesh.group) == "gloo"
    world = dist.get_world_size(mesh.group)
    ks_of = {r: sorted(k for k, (_, o) in owners.items() if o == r)
             for r in range(world)}
    mine = ks_of[mesh.rank]
    out = {k: [None] * n_out for k in owners}
    for j in range(n_out):
        local = torch.cat([blocks[k][j].to(mesh.lead) for k in mine],
                          dim=-1)
        if via_host:
            local = local.cpu()
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local, group=mesh.group)
        for r, part in enumerate(parts):
            for i, k in enumerate(ks_of[r]):
                out[k][j] = (blocks[k][j] if r == mesh.rank
                             else part[..., i * b:(i + 1) * b])
    return {k: tuple(v) for k, v in out.items()}
