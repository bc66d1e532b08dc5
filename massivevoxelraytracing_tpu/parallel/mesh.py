"""Device-mesh helpers.

The reference's only multi-device story is frame-range SSH splitting
(usecase2_submission/run.py). The replacement here: a jax.sharding.Mesh
with two logical axes --
  'dp'  pixel/ray data parallelism (embarrassing, no collectives)
  'sp'  sample (spp) parallelism, reduced with psum
-- plus frame-parallelism across cards and hosts handled by the batch
driver (apps/rtcamp.py --frame-range, exactly the reference's partitioning).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, sp: int | None = None) -> Mesh:
    """Build a ('dp', 'sp') mesh over the first n_devices devices.

    sp defaults to the largest power-of-two factor <= 4 so small meshes keep
    a data axis.
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    devs = devs[:n]
    if sp is None:
        sp = 1
        for cand in (4, 2, 1):
            if n % cand == 0 and n // cand >= 1:
                sp = cand
                break
        if n < 4:
            sp = 1 if n % 2 else 2
            if n == 1:
                sp = 1
    assert n % sp == 0
    dp = n // sp
    arr = np.array(devs).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))
