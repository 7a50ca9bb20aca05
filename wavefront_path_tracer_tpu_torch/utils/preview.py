"""Live progressive preview — the headless analog of the reference's
per-frame display pass (``gpu_wavefront_pt/src/display.rs:112-150``,
continuous redraw ``app.rs:102-121``).

Port of ``wavefront_path_tracer_tpu/utils/preview.py``: host code over
numpy images (the render loop copies each frame to the host once).

Three watch-it-converge channels, all dependency-free:

* PNG-per-frame: the CLI rewrites ``--preview out.png`` after every
  frame batch (any image viewer that reloads on change works).
* Auto-refresh HTML: a tiny viewer page polling the PNG ~2x/s —
  ``start_preview`` writes it next to the PNG once.
* Terminal: 24-bit ANSI half-block rendering (two image rows per text
  row via the upper-half-block glyph), downscaled to the terminal.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

_HTML = """<!doctype html>
<title>wavefront_path_tracer_tpu_torch preview</title>
<style>
  body {{ background: #111; margin: 0; display: grid; place-items: center;
         min-height: 100vh; color: #888; font: 13px monospace; }}
  img {{ image-rendering: pixelated; max-width: 96vw; max-height: 92vh; }}
</style>
<div>
  <img id="v" src="{png}">
  <p id="s">waiting for frames…</p>
</div>
<script>
  const v = document.getElementById("v"), s = document.getElementById("s");
  let n = 0;
  setInterval(() => {{
    v.src = "{png}?" + (++n);
    s.textContent = "refresh #" + n + " — " + new Date().toLocaleTimeString();
  }}, 500);
</script>
"""


def write_preview_html(png_path: str) -> str:
    """Write an auto-refreshing viewer page beside the PNG; returns its path."""
    html_path = os.path.splitext(png_path)[0] + ".html"
    with open(html_path, "w") as f:
        f.write(_HTML.format(png=os.path.basename(png_path)))
    return html_path


def ansi_preview(image: np.ndarray, max_cols: int | None = None,
                 max_rows: int | None = None) -> str:
    """Render an (H, W, 3) float [0,1] image as 24-bit ANSI half-blocks.

    Each text row shows two image rows ('▀' with foreground = upper
    pixel, background = lower pixel), so an 80x24 terminal previews
    ~160x46 pixels.
    """
    if max_cols is None or max_rows is None:
        size = shutil.get_terminal_size((100, 30))
        max_cols = max_cols or size.columns
        max_rows = max_rows or max(4, size.lines - 4)
    h, w = image.shape[:2]
    cols = min(max_cols, w)
    rows2 = min(max_rows * 2, h)  # image rows shown
    ys = (np.arange(rows2) * h) // rows2
    xs = (np.arange(cols) * w) // cols
    img = (np.clip(image[np.ix_(ys, xs)], 0.0, 1.0) * 255.0 + 0.5)
    img = img.astype(np.int32)
    lines = []
    for r in range(0, rows2 - 1, 2):
        top, bot = img[r], img[r + 1]
        line = "".join(
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        )
        lines.append(line + "\x1b[0m")
    return "\n".join(lines)


def term_preview_frame(image: np.ndarray, status: str = "",
                       stream=None) -> None:
    """Draw one progressive frame in place (cursor-home, no flicker)."""
    stream = stream or sys.stderr
    body = ansi_preview(image)
    stream.write("\x1b[H\x1b[2J" + body + "\n" + status + "\n")
    stream.flush()
