"""Device mesh construction (SURVEY.md P7).

The reference has no distributed anything (SURVEY.md §2.2); this build
scales through `jax.sharding.Mesh` + NamedSharding with XLA inserting the
collectives.  Axis convention:

  - ``data``: sequence chunks (DP with 1-frame halos, SURVEY.md P1)
  - ``model``: reserved for sharding the match-cost matrix / BA blocks
    (SURVEY.md P3/P5)
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_model
    use = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(use, ("data", "model"))


def make_pipe_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Build the 2-device ('pipe',) mesh for staged odometry (SURVEY.md
    P4, parallel/pp_odometry.py): stage 0 = feature front-end, stage 1 =
    match/solve back-end."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < 2:
        raise ValueError("pipeline parallelism needs 2 devices")
    return Mesh(np.asarray(devices[:2]), ("pipe",))
