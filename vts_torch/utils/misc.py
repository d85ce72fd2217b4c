"""Miscellaneous host utilities (``vts_tpu/utils/misc.py``; reference
myutils.py:14-144): a dated log directory, the metrics table as a CSV (the
reference uploads it to Google Sheets; gspread is not a dependency, so the
table always lands in the CSV), and the postprocess's CLAHE under the
reference's name ``equalize_this``."""

from __future__ import annotations

import csv
import datetime
import os
from typing import Dict, List, Optional

from ..postprocess import equalize_adaptive as equalize_this  # noqa: F401


def create_log_dir_by_date(base: str = "logs") -> str:
    d = os.path.join(base, datetime.date.today().isoformat())
    os.makedirs(d, exist_ok=True)
    return d


def upload_metrics_table(rows: List[Dict[str, float]], sheet_name: str,
                         out_dir: str = "logs", credentials: Optional[str] = None) -> str:
    """``<out_dir>/<sheet_name>.csv`` with one row per dict, the union of
    their keys sorted as the columns (nothing written for no rows); returns
    its path."""
    if credentials:
        try:
            import gspread  # noqa: F401
        except ImportError:
            print("[misc] gspread not installed — writing CSV instead")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{sheet_name}.csv")
    if rows:
        keys = sorted({k for r in rows for k in r})
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(rows)
    return path
