"""L5 visualization — scene-graph HTML and instance-label renders (port of
``or4d_tpu/utils/visualize.py``: the same HTML bytes, the same plots).

Reference: `helpers/scene_graph_vis_helpers.py:6-69` (pyvis interactive
graphs), `visualize_scene_graph_predictions.py`, and
`visualize_instance_labels.py` (open3d windows). Here:
  * scene graphs render to a self-contained HTML file (embedded
    vis-network-style force layout in plain SVG/JS, no external deps);
  * instance-labeled clouds render to PNG via matplotlib 3D scatter
    (headless-safe), colored with the reference OBJECT_COLOR_MAP.
"""

from __future__ import annotations

import html
import json
from pathlib import Path

import numpy as np

# reference helpers/configurations.py OBJECT_COLOR_MAP
OBJECT_COLOR_MAP = {
    "anesthesia_equipment": (0.96, 0.576, 0.65),
    "operating_table": (0.2, 0.83, 0.72),
    "instrument_table": (0.93, 0.65, 0.93),
    "secondary_table": (0.90, 0.30, 0.63),
    "instrument": (1.0, 0.811, 0.129),
    "object": (0.61, 0.48, 0.04),
    "Patient": (0, 1.0, 0),
    "human_0": (1.0, 0.0, 0),
    "human_1": (0.9, 0.0, 0),
    "human_2": (0.85, 0.0, 0),
    "human_3": (0.8, 0.0, 0),
    "human_4": (0.75, 0.0, 0),
    "human_5": (0.7, 0.0, 0),
    "human_6": (0.65, 0.0, 0),
    "human_7": (0.6, 0.0, 0),
}


def _color_for(name: str) -> str:
    rgb = OBJECT_COLOR_MAP.get(name, (0.5, 0.5, 0.5))
    return "#%02x%02x%02x" % tuple(int(c * 255) for c in rgb)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; background: #fafafa; }}
 svg {{ border: 1px solid #ddd; background: white; }}
 text {{ font-size: 11px; }}
</style></head>
<body><h3>{title}</h3><div id="graph"></div>
<script>
const nodes = {nodes};
const edges = {edges};
const W = 900, H = 620, cx = W/2, cy = H/2;
nodes.forEach((n, i) => {{
  const a = 2 * Math.PI * i / nodes.length;
  n.x = cx + 230 * Math.cos(a); n.y = cy + 230 * Math.sin(a);
}});
// light force relaxation
for (let it = 0; it < 300; it++) {{
  edges.forEach(e => {{
    const a = nodes[e.from], b = nodes[e.to];
    const dx = b.x - a.x, dy = b.y - a.y, d = Math.hypot(dx, dy) || 1;
    const f = (d - 160) * 0.01;
    a.x += f * dx / d; a.y += f * dy / d; b.x -= f * dx / d; b.y -= f * dy / d;
  }});
  nodes.forEach(a => nodes.forEach(b => {{
    if (a === b) return;
    const dx = b.x - a.x, dy = b.y - a.y, d2 = dx*dx + dy*dy + 1;
    const f = 3000 / d2;
    const d = Math.sqrt(d2);
    a.x -= f * dx / d; a.y -= f * dy / d;
  }}));
}}
let svg = `<svg width="${{W}}" height="${{H}}">`;
svg += `<defs><marker id="arr" markerWidth="8" markerHeight="8" refX="22" refY="4" orient="auto"><path d="M0,0 L8,4 L0,8" fill="#888"/></marker></defs>`;
edges.forEach(e => {{
  const a = nodes[e.from], b = nodes[e.to];
  svg += `<line x1="${{a.x}}" y1="${{a.y}}" x2="${{b.x}}" y2="${{b.y}}" stroke="#aaa" marker-end="url(#arr)"/>`;
  svg += `<text x="${{(a.x+b.x)/2}}" y="${{(a.y+b.y)/2 - 4}}" fill="#555">${{e.label}}</text>`;
}});
nodes.forEach(n => {{
  svg += `<circle cx="${{n.x}}" cy="${{n.y}}" r="18" fill="${{n.color}}" stroke="#333"/>`;
  svg += `<text x="${{n.x}}" y="${{n.y - 24}}" text-anchor="middle">${{n.label}}</text>`;
}});
svg += `</svg>`;
document.getElementById("graph").innerHTML = svg;
</script></body></html>
"""


def scene_graph_to_html(relations: list, path: str | Path, title: str = "scene graph") -> None:
    """[(sub, rel, obj), ...] -> interactive-ish HTML graph file."""
    names: list[str] = []
    for s, r, o in relations:
        for n in (s, o):
            if n not in names:
                names.append(n)
    nodes = [{"id": i, "label": html.escape(n), "color": _color_for(n)} for i, n in enumerate(names)]
    edges = [
        {"from": names.index(s), "to": names.index(o), "label": html.escape(r)} for s, r, o in relations
    ]
    Path(path).write_text(
        _HTML_TEMPLATE.format(title=html.escape(title), nodes=json.dumps(nodes), edges=json.dumps(edges))
    )


def instance_labels_to_png(
    points: np.ndarray, labels: np.ndarray, path: str | Path, max_points: int = 20000, title: str = ""
) -> None:
    """Labeled cloud -> 3D scatter PNG (headless replacement for the open3d
    window in visualize_instance_labels.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from or4d_tpu_torch.config import OBJECT_LABEL_MAP

    label_to_name = {v: k for k, v in OBJECT_LABEL_MAP.items()}
    n = len(points)
    if n > max_points:
        sel = np.random.default_rng(0).choice(n, max_points, replace=False)
        points, labels = points[sel], labels[sel]

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    for lab in np.unique(labels):
        m = labels == lab
        name = label_to_name.get(int(lab), "background")
        color = OBJECT_COLOR_MAP.get(name, (0.7, 0.7, 0.7)) if lab >= 0 else (0.85, 0.85, 0.85)
        ax.scatter(points[m, 0], points[m, 1], points[m, 2], s=1, color=color, label=name if lab >= 0 else None)
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=7, markerscale=6)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def confusion_matrix_png(y_true, y_pred, labels: list[str], path: str | Path, title: str = "") -> None:
    """The reference plot_confusion_matrix.py equivalent."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(labels)
    cm = np.zeros((n, n))
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        if 0 <= t < n and 0 <= p < n:
            cm[t, p] += 1
    with np.errstate(invalid="ignore"):
        norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
    ax.set_xticks(range(n), labels, rotation=60, ha="right", fontsize=7)
    ax.set_yticks(range(n), labels, fontsize=7)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    ax.set_title(title)
    fig.colorbar(im)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
