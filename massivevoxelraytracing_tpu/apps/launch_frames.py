"""Frame-range fan-out driver -- the usecase2_submission/run.py equivalent.

The reference splits a shot across two machines by launching
`RTCamp --frame-range A B` over SSH (run.py:14-27, no communication).
Frames are embarrassingly parallel, so this driver just partitions
[0, frames) and launches one rtcamp process per worker. Workers are local
subprocesses by default, one per GPU: a JAX process reserves most of a
card's memory, so two on one card fail. Pass --ssh host1 host2 ... to fan
out over SSH exactly like the reference (requires passwordless ssh and this
repo at the same path remotely).

Usage:
  python -m massivevoxelraytracing_tpu.apps.launch_frames --frames 24 \
      --workers 2 -- --scene torus --width 480 --height 300 --steps 1
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys


def partition(n_frames: int, n_workers: int):
    """Contiguous frame ranges, same arithmetic as run.py's split."""
    base = n_frames // n_workers
    rem = n_frames % n_workers
    ranges = []
    start = 0
    for w in range(n_workers):
        cnt = base + (1 if w < rem else 0)
        ranges.append((start, start + cnt))
        start += cnt
    return ranges


def gpu_count() -> int:
    """GPUs on this host, counted by nvidia-smi in a child process (the
    launcher never opens a card itself). 0 when there is none, or when the
    run is held to the CPU (MVRT_PLATFORM or JAX_PLATFORMS = cpu)."""
    if "cpu" in (os.environ.get("MVRT_PLATFORM"),
                 os.environ.get("JAX_PLATFORMS")):
        return 0
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    return sum(ln.startswith("GPU ") for ln in out.stdout.splitlines())


def local_worker_envs(n_workers: int, n_cards: int, base_env: dict):
    """Environment of each local worker: worker w sees only the w-th card
    (of CUDA_VISIBLE_DEVICES when that is set). Refuses more workers than
    cards. With no cards (a CPU run) the environment is left as it is."""
    if n_cards == 0:
        return [dict(base_env) for _ in range(n_workers)]
    visible = [c for c in base_env.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if c.strip()] or [str(i) for i in range(n_cards)]
    if n_workers > len(visible):
        raise SystemExit(
            f"{n_workers} local workers but {len(visible)} GPUs: each worker "
            f"needs a card of its own")
    return [dict(base_env, CUDA_VISIBLE_DEVICES=visible[w])
            for w in range(n_workers)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--ssh", nargs="*", default=None,
                    help="remote hosts (one worker per host)")
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="arguments passed through to rtcamp (after --)")
    args = ap.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]

    hosts = args.ssh
    n_workers = len(hosts) if hosts else args.workers
    ranges = partition(args.frames, n_workers)
    envs = (None if hosts
            else local_worker_envs(n_workers, gpu_count(), dict(os.environ)))

    procs = []
    for w, (a, b) in enumerate(ranges):
        if a == b:
            continue
        cmd = [
            sys.executable, "-m", "massivevoxelraytracing_tpu.apps.rtcamp",
            "--frame-range", str(a), str(b), "--frames", str(args.frames),
        ] + rest
        if hosts:
            remote = f"cd {shlex.quote(os.getcwd())} && " + " ".join(
                shlex.quote(c) for c in cmd
            )
            cmd = ["ssh", hosts[w], remote]
        print(f"[launch] worker {w}: frames [{a}, {b}) -> {' '.join(cmd[:6])}...")
        procs.append(subprocess.Popen(cmd, env=envs and envs[w]))

    rc = 0
    for p in procs:
        rc |= p.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
