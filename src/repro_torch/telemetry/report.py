"""The dry run's tables (per mesh) and the roofline table from its
artifacts, ported from the JAX package's ``telemetry/report.py``.

  PYTHONPATH=src python -m repro_torch.telemetry.report [artifacts/dryrun_torch]

``fits`` is against one H100's 80 GiB (``launch.dryrun.HBM_PER_CHIP_GIB``).
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.configs import SHAPES, assigned_archs
from repro_torch.launch.dryrun import ART, HBM_PER_CHIP_GIB

MESHES = ("single", "multi")


def load(art_dir):
    cells = {}
    for f in os.listdir(art_dir):
        if f.endswith(".json"):
            with open(os.path.join(art_dir, f)) as fh:
                d = json.load(fh)
            cells[(d["arch"], d["shape"], d["mesh"])] = d
    return cells


def fmt_ms(s):
    return f"{s*1e3:.1f}" if s < 10 else f"{s*1e3:.0f}"


def dryrun_table(cells, mesh):
    rows = ["| arch | shape | status | peak GiB | fits | compile s | collectives (per-device ops) |",
            "|---|---|---|---|---|---|---|"]
    for arch in assigned_archs():
        for shape in SHAPES:
            d = cells.get((arch, shape, mesh))
            if d is None:
                rows.append(f"| {arch} | {shape} | MISSING | | | | |")
                continue
            if d["status"] == "skip":
                rows.append(f"| {arch} | {shape} | skip | — | — | — | {d['reason']} |")
                continue
            if d["status"] != "ok":
                rows.append(f"| {arch} | {shape} | ERROR | | | | |")
                continue
            r = d["report"]
            ops = ", ".join(f"{k}×{v}" for k, v in sorted(r["coll_ops"].items()))
            rows.append(
                f"| {arch} | {shape} | ok | {r['mem']['peak_gib']:.2f} | "
                f"{'✓' if d['fits'] else '✗'} | {d['compile_s']:.0f} | {ops} |")
    return "\n".join(rows)


def roofline_table(cells, mesh="single"):
    rows = ["| arch | shape | compute ms | memory ms | collective ms | bottleneck "
            "| useful FLOPs | roofline frac | one-line lever |",
            "|---|---|---|---|---|---|---|---|---|"]
    for arch in assigned_archs():
        for shape in SHAPES:
            d = cells.get((arch, shape, mesh))
            if not d or d.get("status") != "ok":
                continue
            r = d["report"]
            lever = LEVERS.get(r["bottleneck"], "")
            rows.append(
                f"| {arch} | {shape} | {fmt_ms(r['t_compute'])} | "
                f"{fmt_ms(r['t_memory'])} | {fmt_ms(r['t_collective'])} | "
                f"{r['bottleneck']} | {r['useful_flops_ratio']:.3f} | "
                f"{r['roofline_fraction']:.4f} | {lever} |")
    return "\n".join(rows)


LEVERS = {
    "memory": "fuse SSM/attn HBM traffic (Pallas kernel path) / cast & remat policy",
    "collective": "weight-stationary decode matmuls; defer FSDP gathers; compress pod sync",
    "compute": "cut remat recompute; exact-triangle attention; pad-free head sharding",
}


def worst_cells(cells, n=6, mesh="single"):
    rs = [(d["report"]["roofline_fraction"], k) for k, d in cells.items()
          if d.get("status") == "ok" and k[2] == mesh]
    rs.sort()
    return rs[:n]


def main():
    art = sys.argv[1] if len(sys.argv) > 1 else ART
    cells = load(art)
    n_ok = sum(1 for d in cells.values() if d.get("status") == "ok")
    n_skip = sum(1 for d in cells.values() if d.get("status") == "skip")
    n_fit = sum(1 for d in cells.values() if d.get("fits"))
    print(f"<!-- {n_ok} ok / {n_skip} skip / {len(cells)} total; "
          f"{n_fit}/{n_ok} fit {HBM_PER_CHIP_GIB:.0f}GiB -->\n")
    for mesh in MESHES:
        print(f"### Dry-run — {mesh} mesh "
              f"({'2x16x16=512' if mesh == 'multi' else '16x16=256'} chips)\n")
        print(dryrun_table(cells, mesh))
        print()
    print("### Roofline (single-pod, per-device terms)\n")
    print(roofline_table(cells))
    print("\nWorst roofline fractions:", [(f"{f:.4f}", *k[:2])
                                          for f, k in worst_cells(cells)])


if __name__ == "__main__":
    main()
