"""BEV scene drawing (the port's copy of ``mssvt_tpu/utils/visualize.py``;
matplotlib in place of the reference's open3d/mayavi viewers, ref:
tools/visual_utils/{open3d_vis_utils,visualize_utils}.py).

Renders a top-down point cloud with rotated GT (green) and detection (red)
boxes and score labels to a PNG, for ``tools/demo_torch.py --vis_dir``.
matplotlib is imported at the first drawing, not with the module, and a
clear error says so when it is not installed.
"""

from __future__ import annotations

import numpy as np


def _box_corners_bev(boxes):
    """(N, 7) lidar boxes → (N, 4, 2) BEV corner polygons."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    l, w = boxes[:, 3], boxes[:, 4]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    dx = np.stack([l / 2, l / 2, -l / 2, -l / 2], 1)
    dy = np.stack([w / 2, -w / 2, -w / 2, w / 2], 1)
    x = boxes[:, 0:1] + dx * c[:, None] - dy * s[:, None]
    y = boxes[:, 1:2] + dx * s[:, None] + dy * c[:, None]
    return np.stack([x, y], axis=-1)


def require_matplotlib():
    """The matplotlib module; raises a RuntimeError naming the option that
    needs it when it is not installed."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RuntimeError("drawing BEV PNGs (--vis_dir) needs matplotlib, "
                           "which is not installed") from exc
    return matplotlib


def draw_bev_scene(points, det_boxes=None, det_scores=None, det_labels=None,
                   gt_boxes=None, class_names=None, out_file=None,
                   point_range=None, title=None):
    """Save a BEV PNG of the scene. Returns the matplotlib figure."""
    matplotlib = require_matplotlib()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon

    fig, ax = plt.subplots(figsize=(10, 10), facecolor="black")
    ax.set_facecolor("black")
    points = np.asarray(points)
    if len(points):
        inten = points[:, 3] if points.shape[1] > 3 else points[:, 2]
        ax.scatter(points[:, 0], points[:, 1], s=0.2,
                   c=np.clip(inten, 0, 1), cmap="viridis", linewidths=0)

    def _draw(boxes, color, scores=None, labels=None):
        if boxes is None or len(boxes) == 0:
            return
        for i, poly in enumerate(_box_corners_bev(boxes)):
            ax.add_patch(Polygon(poly, closed=True, fill=False,
                                 edgecolor=color, linewidth=1.0))
            # heading tick from center to front-face midpoint
            ctr = poly.mean(0)
            front = (poly[0] + poly[1]) / 2
            ax.plot([ctr[0], front[0]], [ctr[1], front[1]], color=color,
                    linewidth=0.8)
            if scores is not None:
                name = ""
                if labels is not None and class_names is not None:
                    li = int(labels[i]) - 1
                    if 0 <= li < len(class_names):
                        name = f"{class_names[li]} "
                ax.text(poly[:, 0].max(), poly[:, 1].max(),
                        f"{name}{float(scores[i]):.2f}",
                        color=color, fontsize=6)

    _draw(gt_boxes, "lime")
    _draw(det_boxes, "red", det_scores, det_labels)

    if point_range is not None:
        ax.set_xlim(point_range[0], point_range[3])
        ax.set_ylim(point_range[1], point_range[4])
    ax.set_aspect("equal")
    ax.axis("off")
    if title:
        ax.set_title(title, color="white")
    if out_file is not None:
        fig.savefig(out_file, dpi=120, bbox_inches="tight",
                    facecolor="black")
        plt.close(fig)
    return fig
