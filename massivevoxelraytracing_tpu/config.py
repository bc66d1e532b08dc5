"""Engine configuration.

The reference scatters its knobs over three tiers: compile-time #defines
(ENABLE_GPU_DAG, ENABLE_EMBEDED_MASK, SMALL_STACK, USE_PMJ,
EXTRA_IMPLICIT_SAMPLING, block sizes), argv (--frame-range), and live ImGui
state (gridRes, sixSeparating, lens, view modes) -- SURVEY.md section 5.
Here they collapse into one dataclass; apps expose the relevant subset as
CLI flags.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class EngineConfig:
    # voxelization (voxelization.hpp, voxKernel.cu:58-166)
    six_separating: bool = True          # RTCamp uses true (voxKernel.cu:68)
    cap: int = 4                         # candidate-grid size per triangle
    chunk_tris: int = 65536              # triangles per voxelize dispatch

    # octree build (IntersectorOctreeGPU.hpp)
    dag: bool = True                     # ENABLE_GPU_DAG
    # (embedded masks are always on, as in the reference's shipping config)

    # path tracer (renderCommon.hpp:13-15, voxKernel.cu:610-777)
    use_pmj: bool = True                 # USE_PMJ
    extra_implicit_sampling: bool = True  # EXTRA_IMPLICIT_SAMPLING
    max_bounces: int = 8
    n_batch_spp: int = 16                # nBatchSpp
    emission_scale: float = 7.5          # IntersectorOctreeGPU.hpp:273
    hdri_scale: float = 1.75             # renderCommon.hpp:480

    # execution shape (the analog of the reference block-size macros,
    # IntersectorOctreeGPU.hpp:13-19). Traversal dispatch blocks are
    # per-structure tuned constants (models/accel.py:BLOCK_FOR_KIND).
    ray_packet: int = 65536

    # camera
    fovy_deg: float = 40.0
    lens_r: float = 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "EngineConfig":
        return EngineConfig(**json.loads(s))


DEFAULT = EngineConfig()
