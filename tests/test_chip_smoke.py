"""chip_smoke.py: refuses to run without a GPU, and its phase functions run
end to end at toy size on the CPU (the rehearsal of the on-card run)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from massivevoxelraytracing_tpu.utils import meshgen, png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, path], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _printed_ok(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    try:
        return bool(lines) and json.loads(lines[-1]).get("ok") is True
    except json.JSONDecodeError:
        return False


def test_exits_nonzero_without_gpu():
    r = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert r.returncode != 0
    assert not _printed_ok(r.stdout)
    assert "needs a gpu device" in r.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert r.returncode != 0
    assert not _printed_ok(r.stdout)


def test_device_phase_refuses_cpu():
    with pytest.raises(SystemExit):
        chip_smoke.device_phase("gpu")
    assert chip_smoke.device_phase("cpu")["platform"] == "cpu"


def test_failed_phase_prints_and_reraises(capsys):
    def boom():
        raise AssertionError("mismatch")

    with pytest.raises(AssertionError):
        chip_smoke.run_phase("card", "x", boom)
    assert "[chip_smoke] x FAILED" in capsys.readouterr().out


@pytest.fixture(scope="module")
def toy():
    """A 2^3 sphere lattice at 32^3 through the build phase."""
    mesh = meshgen.sphere_lattice(2, 1)
    tree, info = chip_smoke.build_phase(mesh, 32)
    return mesh, tree, info


def test_build_phase_toy(toy):
    mesh, tree, info = toy
    assert info["n_unique"] == tree.n_voxels > 0
    assert info["n_nodes"] == tree.n_nodes
    with pytest.raises(AssertionError):
        chip_smoke.build_phase(mesh, 32, expect_unique=info["n_unique"] + 50)


def test_primary_phase_toy(toy):
    mesh, tree, _ = toy
    info = chip_smoke.primary_phase(tree, mesh, 32, 48, 40, reps=1)
    assert info["rays"] == 128 * 128  # one 128x128 tile covers the frame
    assert 0.0 < info["hit_frac"] < 1.0


def test_oracle_phase_toy():
    info = chip_smoke.oracle_phase(grid_res=32, n_side=16)
    assert info["rays"] == 256 and info["rays_hit"] > 0


def test_pt_phase_toy(toy):
    _, tree, _ = toy
    info = chip_smoke.pt_phase(tree, 32, 24, 16, steps=1)
    assert info["spp_per_step"] == 16 and len(info["step_s"]) == 1


def test_app_phase_toy(tmp_path, capsys):
    info = chip_smoke.app_phase(str(tmp_path), 24, 16, 16, 16,
                                scene_name="torus")
    assert [f["frame"] for f in info["frames"]] == [0, 1]
    assert png.read(str(tmp_path / "001.png")).shape == (16, 24, 3)


def test_four_card_phases_toy(toy):
    mesh, _, _ = toy
    tree, info = chip_smoke.sharded_build_phase(mesh, 32, 4)
    assert info["voxels_one"] > 0
    info = chip_smoke.sharded_primary_phase(tree, mesh, 32, 48, 40, 4,
                                            reps=1)
    assert info["rays_classified"] <= 2
    info = chip_smoke.sharded_pt_phase(tree, 32, 24, 16, 4)
    assert info["mesh"] == {"dp": 1, "sp": 4}
    assert np.isfinite(info["mean_rel_diff"])
