"""The launch layer's mesh.  Port of ``src/repro/launch/mesh.py``.

The reference builds a TPU pod's 16 x 16 mesh (2 x 16 x 16 over two pods).
The port runs on one H100: its production mesh is {"data": 1, "model": 1}
on that card, and a mesh of more devices raises.  A :class:`Mesh` names its
axes and their sizes (``shape``, ordered as jax's ``Mesh.shape``) and the
devices it spans; :meth:`Mesh.abstract` describes a mesh of any size with
no devices, as jax's ``AbstractMesh`` does, for the sharding plan's specs.
Building a mesh is a function call: importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.device import resolve_device

_ONE_CARD = ("the port's launch layer runs on one card: multi-card meshes are "
             "out of its scope")


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()      # () for an abstract mesh

    @classmethod
    def abstract(cls, sizes, names) -> "Mesh":
        """A mesh of these axis sizes and names, spanning no device."""
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axes")
        return cls(tuple(names), tuple(int(s) for s in sizes))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def device(self) -> torch.device:
        """The one device of a one-card mesh."""
        if len(self.devices) != 1:
            raise ValueError(f"a mesh of {len(self.devices)} devices has no one "
                             f"device; {_ONE_CARD}")
        return self.devices[0]


def _one_card(shape, axes, device) -> Mesh:
    if math.prod(shape) != 1:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} devices; {_ONE_CARD}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(axes), tuple(shape), (dev,))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = "cuda") -> Mesh:
    """The one-card mesh {"data": 1, "model": 1} on the CUDA card, or on
    the device the caller names.  ``multi_pod`` (the reference's two-pod
    mesh) raises."""
    if multi_pod:
        raise ValueError(f"multi_pod asks for 512 devices; {_ONE_CARD}")
    return _one_card((1, 1), ("data", "model"), device)


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device: Optional[str] = "cuda") -> Mesh:
    """An (n_data, n_model) mesh: one card, so only 1 x 1 is built."""
    return _one_card((n_data, n_model), ("data", "model"), device)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh: ('pod','data') or ('data',)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)
