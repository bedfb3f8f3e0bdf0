"""The host's device layout for the train launcher (from
``repro.launch.mesh``; ``make_production_mesh``, a multi-host mesh, is not
ported yet: ROADMAP queue A, item 16).

The port runs one process: the mesh it trains on is a tuple of devices
with axes ``("data", "model")``, one device on the data axis.  Nothing
here touches a device when the module is imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device


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
