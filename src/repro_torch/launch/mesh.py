"""Device layouts (from ``repro.launch.mesh``).

``make_production_mesh`` names the reference's production mesh, 16 x 16
chips (``("data", "model")``) or 2 x 16 x 16 (``("pod", "data",
"model")``), as axis sizes and no devices: the port has one card, not 256
chips.  Its one use is to fix how much work that card does, one
data-parallel replica's share of a cell (``launch.dryrun``).

The port runs one process: the mesh it trains on is a tuple of devices
with axes ``("data", "model")``, one device on the data axis
(``make_host_mesh``).  Nothing here touches a device when the module is
imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """Axis name -> size of the reference's production mesh (its
    ``jax.make_mesh(...).shape``), in its axis order."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


@dataclass(frozen=True)
class HostMesh:
    """An ordered device tuple with named axes; ``shape`` maps each axis
    to its size (``data_parallel_size`` reads it)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}


def make_host_mesh(device: Union[str, torch.device] = "cuda") -> HostMesh:
    """The one-process mesh: ``device`` alone on the data axis, the model
    axis of size 1."""
    return HostMesh((resolve_device(device),))
