"""Minimal HTML gallery writer: the port's copy of ``vts_tpu/utils/html.py``
(without the page refresh, which neither driver sets)."""

from __future__ import annotations

import html as _html
import os
from typing import List, Sequence


class HTML:
    def __init__(self, web_dir: str, title: str):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self._body: List[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self._body.append(f"<h3>{_html.escape(str(text))}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Sequence[str], width: int) -> None:
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td halign='center' style='word-wrap: break-word;' valign='top'>"
                f"<p><a href='images/{link}'><img src='images/{im}' "
                f"style='width:{width}px'></a><br><p>{_html.escape(str(txt))}</p></p></td>")
        self._body.append(
            "<table border='1' style='table-layout: fixed;'><tr>" + "".join(cells)
            + "</tr></table>")

    def save(self) -> str:
        """Write ``<web_dir>/index.html``."""
        doc = (f"<!DOCTYPE html><html><head><title>{_html.escape(self.title)}</title>"
               f"</head><body>" + "\n".join(self._body) + "</body></html>")
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write(doc)
        return path
