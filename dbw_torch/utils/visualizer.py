"""Live training dashboard (a port of dbw_tpu/utils/visualizer.py): image
panels and line charts written as a self-refreshing static HTML page in
``run_dir/dashboard``. It does nothing unless the config's
``training.visualizer_port`` is set, and its line charts need matplotlib."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .image import convert_to_img
from .misc import path_mkdir
from .plot import _pyplot

_PAGE = """<!DOCTYPE html><html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="30">
<title>{title}</title>
<style>body{{font-family:sans-serif;margin:1.5em;background:#fafafa}}
img{{max-width:420px;margin:4px;border:1px solid #ddd}}
h3{{margin:12px 0 4px}}</style></head><body>
<h2>{title}</h2>{body}</body></html>"""


class Visualizer:
    def __init__(self, enabled, run_dir):
        """``enabled``: the config's visualizer port; falsy -> no-op."""
        self.enabled = bool(enabled)
        if not self.enabled:
            return
        self.run_dir = Path(run_dir)
        self.dash_dir = path_mkdir(self.run_dir / "dashboard")
        self.title = self.run_dir.name
        self._panels = {}
        self._history = {}

    def _write_index(self):
        body = []
        for name in sorted(self._panels):
            body.append(f"<h3>{name}</h3>")
            body.append(f'<img src="{self._panels[name]}">')
        (self.dash_dir / "index.html").write_text(
            _PAGE.format(title=self.title, body="\n".join(body)))

    def upload_images(self, images, title, nrow=4, max_size=None):
        if not self.enabled:
            return
        images = np.asarray(images)
        nrow = max(1, min(nrow, len(images)))
        rows = []
        for i in range(0, len(images), nrow):
            chunk = list(images[i:i + nrow])
            while len(chunk) < nrow:
                chunk.append(np.zeros_like(chunk[0]))
            rows.append(np.concatenate(chunk, axis=1))
        img = convert_to_img(np.concatenate(rows, axis=0))
        if max_size and max(img.size) > max_size:
            r = max_size / max(img.size)
            img = img.resize((int(img.width * r), int(img.height * r)))
        fname = f"{title}.png"
        img.save(self.dash_dir / fname)
        self._panels[title] = fname
        self._write_index()

    def upload_lineplot(self, it, named_values, title, colors=None):
        if not self.enabled:
            return
        plt = _pyplot()
        if plt is None:
            return
        hist = self._history.setdefault(title, [])
        hist.append((it, dict(named_values)))
        fig, ax = plt.subplots(figsize=(6, 3.2))
        for i, name in enumerate(hist[-1][1]):
            xs = [h[0] for h in hist if name in h[1]]
            ys = [h[1][name] for h in hist if name in h[1]]
            c = None if colors is None else np.asarray(colors[i]) / 255.0
            ax.plot(xs, ys, label=name, color=c)
        ax.legend(fontsize=6)
        ax.set_title(title)
        fig.tight_layout()
        fname = f"{title}.png"
        fig.savefig(self.dash_dir / fname)
        plt.close(fig)
        self._panels[title] = fname
        self._write_index()
