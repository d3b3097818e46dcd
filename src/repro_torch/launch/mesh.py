"""Device meshes (port of ``repro.launch.mesh``) on ``torch.distributed``.

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2, data=16,
model=16) = 512 devices; the ``pod`` axis extends the data-parallel
domain across the boundary between nodes. A pipeline adds a ``stage``
axis (``("stage",)`` or ``("stage", "data", "model")``;
``launch.pipeline``), which the helpers below leave out of the data
domain.

:func:`make_production_mesh` is a function, never a module constant:
importing this module touches no process group. A mesh is a
``torch.distributed.device_mesh.DeviceMesh``; it needs the default
process group of ``prod(shape)`` ranks (``torchrun`` sets it up, or
``torch.distributed.init_process_group`` with the address, world size and
rank). The device type is ``cuda`` unless the caller asks for ``cpu``
(gloo under the tests, the ``fake`` group under the dry run).

The helpers below read any object with the JAX mesh's shape interface
too (``shape`` a dict of axis sizes, ``axis_names``), so the partition
rules run on a shape-only stand-in with no process group.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple

_CURRENT = []      # the stack of meshes ``activate_mesh`` installed


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """``init_device_mesh`` over ``shape`` with axis names ``axes``; the
    device type is ``cuda`` unless ``device_type`` says otherwise. On
    ``cuda`` a host without a card, or a process group not on NCCL,
    raises: a mesh on the card never carries on with gloo."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    device_type = device_type or "cuda"
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axes)}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available on this host: a mesh "
                               "on the card needs one (device_type='cpu' "
                               "for gloo)")
        if dist.is_initialized() and dist.get_backend() != "nccl":
            raise RuntimeError(f"a cuda mesh needs the nccl backend, the "
                               f"process group runs {dist.get_backend()}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def activate_mesh(mesh) -> Iterator:
    """Install ``mesh`` as the current one for the block (``jax.set_mesh``'s
    counterpart): :func:`current_mesh` returns it."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost mesh :func:`activate_mesh` installed, or None."""
    return _CURRENT[-1] if _CURRENT else None


def production_shape(*, multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, axis) -> int:
    """Devices along ``axis``: a name or a tuple of names (their product)."""
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= axis_size(mesh, a)
        return n
    if isinstance(mesh.shape, dict):
        return int(mesh.shape[axis])
    return int(mesh.shape[axis_names(mesh).index(axis)])


def _mesh(mesh):
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("no mesh given and none active (activate_mesh)")
    return mesh


def data_axes(mesh=None) -> tuple:
    """The axes forming the data-parallel domain (of the active mesh when
    ``mesh`` is None): ``pod`` and ``data``, those the mesh has (none on
    a ``("stage",)`` mesh)."""
    names = axis_names(_mesh(mesh))
    if "pod" in names:
        return ("pod", "data")
    return ("data",) if "data" in names else ()


def dp_size(mesh=None) -> int:
    return axis_size(_mesh(mesh), data_axes(mesh))


def tp_size(mesh=None) -> int:
    """Devices along ``model`` (1 on a mesh without that axis)."""
    mesh = _mesh(mesh)
    return axis_size(mesh, "model") if "model" in axis_names(mesh) else 1
