"""The metric roll-up (``vts_tpu/utils/compile_metrics.py``; reference
util/compile_eval_metrics_sinskitG.py:18-256).

Reads ``<results_dir>/<material>_<method>/<phase>_<epoch>/eval_metrics.pkl``
for each material (falling back to the last ``<phase>_*`` directory that has
one), strips the ``metric_`` prefixes, adds a ``MEAN`` row over the
materials found, and prints the table as markdown (``--out`` writes it too).
The reference's Google Sheets upload is not a dependency here.

Run:  python -m vts_torch.utils.compile_metrics --results_dir ./results \\
          --method-pattern '{material}_sinskitG_baseline_ours' --phase test --epoch best
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

METRIC_ORDER = ["I_SIFID", "I_LPIPS", "I_PSNR", "I_SSIM",
                "T_SIFID", "T_LPIPS", "T_AE", "T_MSE"]


def load_metrics(results_dir: str, name: str, phase: str, epoch: str) -> Optional[Dict[str, float]]:
    path = os.path.join(results_dir, name, f"{phase}_{epoch}", "eval_metrics.pkl")
    if not os.path.exists(path):
        cands = sorted(glob.glob(os.path.join(results_dir, name, f"{phase}_*",
                                              "eval_metrics.pkl")))
        if not cands:
            return None
        path = cands[-1]
    with open(path, "rb") as f:
        return pickle.load(f)


def compile_metrics_for_exp(results_dir: str, materials: List[str],
                            method_pattern: str, phase: str = "test",
                            epoch: str = "best") -> Dict[str, Dict[str, float]]:
    """{material: {metric: value}} for the materials that have metrics, and
    ``MEAN``: each metric's mean over the materials that have it."""
    table: Dict[str, Dict[str, float]] = {}
    for m in materials:
        name = method_pattern.format(material=m)
        metrics = load_metrics(results_dir, name, phase, epoch)
        if metrics is None:
            print(f"[compile] missing metrics for {name}")
            continue
        table[m] = {k.replace("metric_", ""): float(v) for k, v in metrics.items()}
    if table:
        keys = sorted({k for row in table.values() for k in row})
        table["MEAN"] = {k: float(np.mean([row[k] for row in table.values()
                                           if k in row])) for k in keys}
    return table


def format_table(table: Dict[str, Dict[str, float]]) -> str:
    """Markdown: the 8 metrics in ``METRIC_ORDER`` first, then any others."""
    if not table:
        return "(no metrics found)"
    cols = [c for c in METRIC_ORDER if any(c in row for row in table.values())]
    cols += sorted({k for row in table.values() for k in row} - set(cols))
    lines = ["| material | " + " | ".join(cols) + " |",
             "|---" * (len(cols) + 1) + "|"]
    for mat, row in table.items():
        vals = " | ".join(f"{row.get(c, float('nan')):.4f}" for c in cols)
        lines.append(f"| {mat} | {vals} |")
    return "\n".join(lines)


def main(argv=None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description="per-material metric roll-up")
    ap.add_argument("--results_dir", default="./results")
    ap.add_argument("--materials", default="")
    ap.add_argument("--method-pattern", default="{material}_sinskitG_baseline_ours")
    ap.add_argument("--phase", default="test")
    ap.add_argument("--epoch", default="best")
    ap.add_argument("--out", default="", help="write markdown table here")
    args = ap.parse_args(argv)
    if args.materials:
        materials = args.materials.split(",")
    else:
        from ..launch import DEFAULT_MATERIALS
        materials = DEFAULT_MATERIALS
    table = compile_metrics_for_exp(args.results_dir, materials,
                                    args.method_pattern, args.phase, args.epoch)
    text = format_table(table)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return table


if __name__ == "__main__":
    main()
