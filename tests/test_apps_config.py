"""App-level pieces: config roundtrip, checkpoint/resume, frame partition,
voxtriangle oracle agreement, npz scene IO."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from massivevoxelraytracing_tpu.config import EngineConfig
from massivevoxelraytracing_tpu.apps.launch_frames import (
    local_worker_envs, partition,
)
from massivevoxelraytracing_tpu.models import scene
from massivevoxelraytracing_tpu.models.pathtracer import PathTracer
from massivevoxelraytracing_tpu.ops import camera as camera_ops
from massivevoxelraytracing_tpu.utils import meshgen, objio


def test_config_roundtrip():
    cfg = EngineConfig(six_separating=False, max_bounces=4, lens_r=0.1)
    back = EngineConfig.from_json(cfg.to_json())
    assert back == cfg


def test_frame_partition():
    # matches the reference's two-machine split arithmetic: cover all frames
    # exactly once, contiguous
    for frames, workers in [(240, 2), (24, 5), (7, 3), (3, 8)]:
        r = partition(frames, workers)
        covered = []
        for a, b in r:
            covered.extend(range(a, b))
        assert covered == list(range(frames))


def test_local_workers_get_a_card_each():
    envs = local_worker_envs(3, 4, {"PATH": "/bin"})
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2"]
    assert all(e["PATH"] == "/bin" for e in envs)
    # an existing restriction is split among the workers, not overridden
    envs = local_worker_envs(2, 4, {"CUDA_VISIBLE_DEVICES": "2,3"})
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["2", "3"]


def test_local_workers_refuse_more_than_cards():
    with pytest.raises(SystemExit, match="card of its own"):
        local_worker_envs(3, 2, {})
    with pytest.raises(SystemExit):
        local_worker_envs(3, 4, {"CUDA_VISIBLE_DEVICES": "0,1"})


def test_local_workers_on_cpu_share_the_host():
    # no GPU (a CPU run): any number of workers, environment untouched
    envs = local_worker_envs(5, 0, {"JAX_PLATFORMS": "cpu"})
    assert envs == [{"JAX_PLATFORMS": "cpu"}] * 5


def test_checkpoint_resume(tmp_path):
    tri = meshgen.icosphere(2, radius=0.8)
    origin, dps = meshgen.fit_grid(tri, 16)
    tree = scene.build_scene(tri, origin=origin, dps=dps, grid_res=16)
    pt = PathTracer(width=32, height=24, packet=1024)
    pt.pmj_table = jnp.asarray(
        np.random.default_rng(0).random((128, 4096, 2), np.float32)
    )
    pt.setup()
    env = np.ones((8, 16, 3), np.float32) * 0.3
    pt.load_hdri(env)
    pt.update_scene(tree)
    cam = camera_ops.Camera.look_at(eye=(0, 0.5, 2.5), target=(0, 0, 0))
    pt.step(cam, n_spp=2)
    ck = str(tmp_path / "ck.npz")
    pt.save_checkpoint(ck, frame=5)

    pt2 = PathTracer(width=32, height=24, packet=1024)
    pt2.pmj_table = pt.pmj_table
    pt2.setup()
    pt2.load_hdri(env)
    pt2.update_scene(tree)
    frame = pt2.load_checkpoint(ck)
    assert frame == 5 and pt2.steps == pt.steps
    np.testing.assert_array_equal(np.asarray(pt2.accum), np.asarray(pt.accum))
    # continuing from a checkpoint == continuing the original
    pt.step(cam, n_spp=2)
    pt2.step(cam, n_spp=2)
    np.testing.assert_array_equal(np.asarray(pt2.accum), np.asarray(pt.accum))


def test_npz_scene_roundtrip(tmp_path):
    tri = meshgen.icosphere(1)
    col = np.ones_like(tri) * 0.5
    p = str(tmp_path / "anim.npz")
    np.savez(p, tri_0000=tri, col_0000=col)
    t2, c2, e2 = objio.load_npz_frame(p, 0)
    np.testing.assert_array_equal(t2, tri)
    np.testing.assert_array_equal(c2, col)
    assert np.all(e2 == 0)


def test_voxtriangle_app(tmp_path):
    from massivevoxelraytracing_tpu.apps import voxtriangle

    out = str(tmp_path / "tri")
    voxtriangle.main(["--res", "16", "--out", out])
    assert os.path.exists(os.path.join(out, "coverage.png"))
