"""The dry run's sweep over every cell, ported from the JAX package's
``launch/sweep.py``: every (arch × shape × mesh) cell as a subprocess.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--meshes single] [--archs a,b]

Subprocess isolation keeps one cell's failure (or memory spike) from
killing the sweep, and each process starts its own fake process group. A
cell that outlives ``--timeout`` is killed and recorded as an error; the
sweep goes on.
Resumable: cells with an existing status=ok/skip artifact are not re-run
(pass --force to redo).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import SHAPES, applicable_shapes, assigned_archs, get_config
from repro_torch.launch.dryrun import ART

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cell_done(arch, shape, mesh):
    path = os.path.join(ART, f"{arch}__{shape}__{mesh}.json")
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            return json.load(f).get("status") in ("ok", "skip")
    except Exception:
        return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--archs", default=",".join(assigned_archs()))
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args()

    cells = []
    for mesh in args.meshes.split(","):
        for arch in args.archs.split(","):
            for shape in SHAPES:
                cells.append((arch, shape, mesh))

    t_start = time.time()
    n_ok = n_fail = n_skip = 0
    for i, (arch, shape, mesh) in enumerate(cells):
        if not args.force and cell_done(arch, shape, mesh):
            n_skip += 1
            continue
        reason = applicable_shapes(get_config(arch)).get(shape)
        tag = f"[{i+1}/{len(cells)}] {arch} x {shape} x {mesh}"
        if reason:
            # the skip artifact is written here, with no subprocess
            os.makedirs(ART, exist_ok=True)
            with open(os.path.join(ART, f"{arch}__{shape}__{mesh}.json"), "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "skip", "reason": reason}, f, indent=1)
            print(f"{tag}: SKIP ({reason})", flush=True)
            n_skip += 1
            continue
        t0 = time.time()
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", mesh, "--out", ART]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout,
                               env={**os.environ, "PYTHONPATH": SRC})
        except subprocess.TimeoutExpired:
            # the cell is a finding, not the end of the sweep: an error
            # artifact says so and the next cell runs
            err = f"timed out after {args.timeout} s (--timeout)"
            os.makedirs(ART, exist_ok=True)
            with open(os.path.join(ART, f"{arch}__{shape}__{mesh}.json"), "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                           "error": err}, f, indent=1)
            p = subprocess.CompletedProcess(cmd, 1, "", err)
        ok = p.returncode == 0
        n_ok += ok
        n_fail += (not ok)
        last = [ln for ln in p.stdout.splitlines() if ln.strip()][-1:] or ["?"]
        print(f"{tag}: {'OK' if ok else 'FAIL'} ({time.time()-t0:.0f}s) {last[0][:160]}",
              flush=True)
        if not ok:
            err = (p.stderr or "")[-1500:]
            with open(os.path.join(ART, f"{arch}__{shape}__{mesh}.stderr"), "w") as f:
                f.write(p.stderr or "")
            print("      stderr tail:", err.splitlines()[-1] if err else "?", flush=True)
    print(f"sweep done in {(time.time()-t_start)/60:.1f}min: "
          f"ok={n_ok} fail={n_fail} skip/cached={n_skip}", flush=True)


if __name__ == "__main__":
    main()
