"""Side-by-side comparison galleries (``vts_tpu/utils/compare.py``; reference
tmux_launcher.py:197-226, which shelled out to an external ``html.py``).

Given N result image directories (one per method or experiment) and their
labels, :func:`create_comparison_html` writes one dependency-free HTML page:
one row per image basename over the union of the directories, one column
per method, ``&mdash;`` where a directory lacks the file; images are
referenced by relative path, so the page works from the results tree as is.

Run:  python -m vts_torch.utils.compare --web_dir results/comparison_x \\
          --dirs results/a/test_best/images results/b/test_400/images \\
          --labels ours pix2pixHD [--width 256] [--filter fake_I]
"""

from __future__ import annotations

import argparse
import html as _html
import os
from typing import List, Optional, Sequence

_IMG_EXT = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _listing(d: str) -> List[str]:
    try:
        return sorted(f for f in os.listdir(d) if f.lower().endswith(_IMG_EXT))
    except OSError:
        return []


def create_comparison_html(web_dir: str, dirs: Sequence[str],
                           labels: Sequence[str], width: int = 256,
                           title: str = "comparison",
                           name_filter: Optional[str] = None) -> str:
    """Write ``<web_dir>/index.html`` (only basenames containing
    ``name_filter``, when given) and return its path."""
    if len(dirs) != len(labels):
        raise ValueError(f"{len(dirs)} dirs but {len(labels)} labels")
    os.makedirs(web_dir, exist_ok=True)
    per_dir = [_listing(d) for d in dirs]
    names = sorted(set().union(*per_dir)) if per_dir else []
    if name_filter:
        names = [n for n in names if name_filter in n]

    body: List[str] = ["<tr>" + "".join(
        f"<th style='padding:4px 8px'>{_html.escape(str(l))}</th>" for l in labels) + "</tr>"]
    for name in names:
        cells = []
        for d, files in zip(dirs, per_dir):
            if name in files:
                rel = _html.escape(os.path.relpath(os.path.join(d, name), web_dir), quote=True)
                cells.append(f"<td valign='top'><a href=\"{rel}\">"
                             f"<img src=\"{rel}\" style='width:{width}px'></a></td>")
            else:
                cells.append("<td valign='top'>&mdash;</td>")
        body.append(f"<tr><td colspan='{len(dirs)}' "
                    f"style='background:#f0f0f0;font-family:monospace'>"
                    f"{_html.escape(name)}</td></tr>")
        body.append("<tr>" + "".join(cells) + "</tr>")

    doc = (f"<!DOCTYPE html><html><head><title>{_html.escape(title)}</title>"
           "</head><body>"
           f"<h2>{_html.escape(title)}</h2>"
           f"<p>{len(names)} images &times; {len(dirs)} methods</p>"
           "<table border='1' style='border-collapse:collapse'>"
           + "\n".join(body) + "</table></body></html>")
    path = os.path.join(web_dir, "index.html")
    with open(path, "w") as f:
        f.write(doc)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--web_dir", required=True)
    p.add_argument("--dirs", nargs="+", required=True)
    p.add_argument("--labels", nargs="+", required=True)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--title", default="comparison")
    p.add_argument("--filter", dest="name_filter", default=None,
                   help="only include basenames containing this substring (e.g. fake_I)")
    a = p.parse_args(argv)
    print(create_comparison_html(a.web_dir, a.dirs, a.labels, a.width, a.title, a.name_filter))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
