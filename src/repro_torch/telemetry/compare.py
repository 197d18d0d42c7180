"""Diff two dry-run artifact dirs (baseline vs optimized), ported from the
JAX package's ``telemetry/compare.py``.

  PYTHONPATH=src python -m repro_torch.telemetry.compare \
      artifacts/dryrun_torch_baseline artifacts/dryrun_torch
"""
from __future__ import annotations

import json
import os
import sys


def load(d):
    out = {}
    for f in os.listdir(d):
        if f.endswith(".json"):
            j = json.load(open(os.path.join(d, f)))
            if j.get("status") == "ok":
                out[(j["arch"], j["shape"], j["mesh"])] = j
    return out


def main():
    base = load(sys.argv[1])
    new = load(sys.argv[2])
    print("| cell | term | baseline | optimized | Δ |")
    print("|---|---|---|---|---|")
    for key in sorted(set(base) & set(new)):
        b, n = base[key]["report"], new[key]["report"]
        cell = f"{key[0]} × {key[1]} ({key[2]})"
        changed = False
        for term, fmt in (("t_compute", 1e3), ("t_memory", 1e3),
                          ("t_collective", 1e3)):
            bv, nv = b[term], n[term]
            if bv > 0 and abs(nv - bv) / bv > 0.05:
                changed = True
        pk_b, pk_n = b["mem"]["peak_gib"], n["mem"]["peak_gib"]
        if abs(pk_n - pk_b) / max(pk_b, 1e-9) > 0.05:
            changed = True
        if not changed:
            continue
        for term, label in (("t_compute", "compute ms"),
                            ("t_memory", "memory ms"),
                            ("t_collective", "collective ms")):
            bv, nv = b[term] * 1e3, n[term] * 1e3
            d = (nv - bv) / bv * 100 if bv else 0
            print(f"| {cell} | {label} | {bv:.1f} | {nv:.1f} | {d:+.0f}% |")
        d = (pk_n - pk_b) / pk_b * 100
        print(f"| {cell} | peak GiB | {pk_b:.1f} | {pk_n:.1f} | {d:+.0f}% |")
        fb, fn = b["roofline_fraction"], n["roofline_fraction"]
        print(f"| {cell} | roofline frac | {fb:.4f} | {fn:.4f} | "
              f"{(fn-fb)/max(fb,1e-9)*100:+.0f}% |")


if __name__ == "__main__":
    main()
