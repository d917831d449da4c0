"""Static HTML results gallery: a grid of a run's ``quali_eval`` images
and videos (a port of dbw_tpu/utils/html.py)."""

from __future__ import annotations

from pathlib import Path

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
body {{ font-family: sans-serif; background: #fafafa; margin: 2em; }}
table {{ border-collapse: collapse; }}
td {{ padding: 6px; text-align: center; vertical-align: top; }}
img, video {{ max-width: {width}px; display: block; }}
.caption {{ font-size: 12px; color: #555; margin-top: 2px; }}
</style></head><body>
<h2>{title}</h2>
{body}
</body></html>
"""
PATTERNS = ("*.png", "*.jpg", "*.gif", "*.mp4")
PER_ROW = 6
WIDTH = 256


def _cell(path):
    p = Path(path)
    if p.suffix.lower() == ".mp4":
        media = (f'<video width="{WIDTH}" autoplay loop muted>'
                 f'<source src="{p}" type="video/mp4"></video>')
    else:
        media = f'<img src="{p}" width="{WIDTH}">'
    return f"<td>{media}<div class='caption'>{p.name}</div></td>"


def gallery_from_run_dir(run_dir):
    """Write ``run_dir/index.html``: the directory's media files, PER_ROW a
    row."""
    run_dir = Path(run_dir)
    rel = [f.relative_to(run_dir) for pat in PATTERNS for f in sorted(run_dir.rglob(pat))]
    body = ["<table>"] + [
        "<tr>" + "".join(_cell(c) for c in rel[i:i + PER_ROW]) + "</tr>"
        for i in range(0, len(rel), PER_ROW)] + ["</table>"]
    out = run_dir / "index.html"
    out.write_text(_PAGE.format(title=run_dir.name, body="\n".join(body), width=WIDTH))
    return out
