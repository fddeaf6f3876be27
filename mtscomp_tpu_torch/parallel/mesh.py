"""Device meshes for multi-GPU codec runs: ``mtscomp_tpu/parallel/mesh.py``
ported to PyTorch.

The codec's natural parallel axis is the chunk batch (embarrassingly
parallel, mirroring the reference's thread pool over chunks,
mtscomp.py:456/691): each device decodes or encodes its own chunks'
rANS groups, with no cross-chunk traffic. So a mesh is a list of
devices, one process drives them all, and no collective (and no
``torch.distributed``) is needed: :class:`~.pipeline.DeviceBatchDecoder`
and :class:`~.pipeline.DeviceBatchEncoder` stage one shard on each
device and launch it on that device's current stream.
"""

import contextlib

import torch

from ..device import resolve_device


class ChunkMesh(tuple):
    """A 1-D mesh over the ``'chunks'`` axis: a tuple of ``torch.device``,
    shard ``s`` of a batch on ``mesh[s]``. ``shape`` and ``axis_names``
    read as those of the JAX package's ``jax.sharding.Mesh``."""

    axis_names = ('chunks',)

    @property
    def shape(self):
        return {'chunks': len(self)}

    @property
    def size(self):
        return len(self)


def chunk_mesh(devices=None, n_devices=None):
    """A 1-D mesh over the ``'chunks'`` axis.

    ``devices`` lists the mesh's devices (names or ``torch.device``:
    ``'cuda:N'``, or ``'cpu'`` for the kernels' plain twins, which may
    repeat to stand for several devices); the default is every visible
    CUDA device, the first ``n_devices`` of them when that is given
    (raises when fewer are visible: a silently narrower mesh would later
    fail the batch-divide check, or run at reduced parallelism
    unnoticed). It is an error to pass both arguments, or a CUDA device
    twice (a shard cannot be placed twice on one device).
    """
    if devices is not None and n_devices is not None:
        raise ValueError("Pass devices OR n_devices, not both.")
    if devices is None:
        n_visible = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        if n_devices is not None and n_visible < n_devices:
            raise ValueError(
                "Requested a %d-device mesh but only %d devices "
                "are available." % (n_devices, n_visible))
        devices = [torch.device('cuda', i)
                   for i in range(n_visible if n_devices is None
                                  else n_devices)]
    mesh = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == 'cuda' and dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        if dev.type == 'cuda' and dev in mesh:
            raise ValueError("device %s appears twice in the mesh: each "
                             "CUDA device holds one shard." % dev)
        mesh.append(dev)
    if not mesh:
        raise ValueError("A mesh needs at least one device (no CUDA device "
                         "is visible; pass devices=['cpu'] * n to run the "
                         "plain twins).")
    return ChunkMesh(mesh)


def mesh_devices(mesh):
    """The devices of ``mesh`` (a :class:`ChunkMesh`), or None for None;
    anything else raises TypeError."""
    if mesh is None:
        return None
    if not isinstance(mesh, ChunkMesh):
        raise TypeError("mesh must be a ChunkMesh from "
                        "mtscomp_tpu_torch.parallel.mesh.chunk_mesh, or None; "
                        "got %r" % (mesh,))
    return mesh


def on_device(device):
    """Context that makes ``device`` PyTorch's current CUDA device, and
    restores the previous one after (the kernels' C entries select their
    device themselves); nothing for a CPU device."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()
