"""Massive voxel renderer ("Hako") in JAX/XLA.

A brand-new JAX/XLA implementation of the capabilities of the Hako-1.0
reference renderer (Ushio/MassiveVoxelRayTracing): Schwarz-style conservative /
6-separating triangle voxelization, Morton-sorted bottom-up sparse-voxel-octree
(SVO/DAG) construction, Revelles-style parametric octree traversal, and a
progressive diffuse path tracer with PMJ(0,2) sampling and HDR-environment
importance sampling. Sorted/segmented XLA array ops replace atomics and
lock-free hash tables, and the traversal is a lockstep state machine over
ray packets: the BrickTree walk (ops/bricktree.py) in production, the octree
walks (ops/traverse.py, ops/traverse2.py) as references.

Layer map (mirrors SURVEY.md section 1 of the reference):
  ops/       L0-L1: math, morton, hashing, rng, voxelizer, octree build,
             traversal, sampling, HDRI (pure JAX)
  models/    L2/L4: CPU oracles (numpy), raycast engine, PathTracer facade
  parallel/  multi-device sharding (mesh/shard_map) replacing run.py
  utils/     host runtime: mesh IO, PNG/HDR IO, procedural scenes, timing
  apps/      L5: rtcamp batch CLI, voxrt A/B lab, voxmesh exporter
"""

__version__ = "0.1.0"
