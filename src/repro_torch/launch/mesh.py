"""Production mesh construction: the port's counterpart of
``repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module touches
no device or process-group state.  Single pod: (data=16, model=16) = 256
ranks.  Multi-pod: (pod=2, data=16, model=16) = 512 ranks; the ``pod``
axis carries pure data parallelism over the slow cross-pod link.

Each is ``init_device_mesh`` over the default process group (which the
caller initialises, e.g. ``repro_torch.distributed.ranks``) with the
reference's axis names, on the card's device type unless the caller asks
for ``"cpu"``.
"""

from __future__ import annotations

import math

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..distributed.sharding import mesh_shape


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """Arbitrary mesh (tests, elastic re-mesh)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def devices_per_pod(mesh) -> int | None:
    shape = mesh_shape(mesh)
    if "pod" not in shape:
        return None
    return math.prod(shape.values()) // shape["pod"]
