"""Animation / GIF visualization of ensemble fields.

A copy of ``gwen_tpu.viz``: per-time-step frames in the ``RdBu_r`` colormap
with 1–99 percentile color limits, one GIF per member named after the
member's physical parameters (``get_member_name`` parses the member id
"temp_height_width" into a title), encoded with Pillow. matplotlib and
Pillow are imported inside the functions that need them, so the package
imports where they are absent; a call then raises ``RuntimeError``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

def get_member_name(member_id: str) -> str:
    """'-10.0_3000.0_2000.0' → 'Temp: -10 °C; Height: 3000 m; Width: 2000 m'
    (create_gif.py:141-162, including the unit suffixes and the reference's
    ``.replace(".0", "")`` integer formatting)."""
    parts = str(member_id).split("_")
    labels_units = [("Temp", "°C"), ("Height", "m"), ("Width", "m")]
    fields = [
        f"{label}: {part.replace('.0', '')} {unit}"
        for (label, unit), part in zip(labels_units, parts)
    ]
    return "; ".join(fields) if fields else str(member_id)


def _percentile_clim(data: np.ndarray) -> tuple[float, float]:
    lo, hi = np.nanpercentile(data, [1, 99])
    if lo == hi:
        lo, hi = lo - 1e-6, hi + 1e-6
    return float(lo), float(hi)


def render_frames(
    data: np.ndarray,
    title: str = "",
    cmap: str = "RdBu_r",
    dpi: int = 80,
) -> list[np.ndarray]:
    """Render (time, height, ncells) into RGB frame arrays."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as err:
        raise RuntimeError("matplotlib is required for visualization") from err
    vmin, vmax = _percentile_clim(data)
    frames = []
    fig, ax = plt.subplots(figsize=(6, 4), dpi=dpi)
    im = ax.imshow(
        data[0], origin="lower", aspect="auto", cmap=cmap, vmin=vmin, vmax=vmax
    )
    fig.colorbar(im, ax=ax)
    for t in range(data.shape[0]):
        im.set_data(data[t])
        ax.set_title(f"{title} t={t}")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
    plt.close(fig)
    return frames


def save_gif(frames: list[np.ndarray], path: str | Path, fps: int = 5) -> Path:
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError("Pillow is required to write GIFs") from err

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return path


def create_animation(
    data: np.ndarray,
    member_id: str,
    out_dir: str | Path,
    label: str = "GNN",
    var_name: str = "theta_v",
) -> Path:
    """Per-member GIF (utils.py:286-352): data is (time, height, ncells)."""
    title = f"{label} {var_name} — {get_member_name(member_id)}"
    frames = render_frames(np.asarray(data), title=title)
    fname = f"animation_member_{member_id}_{label}.gif"
    return save_gif(frames, Path(out_dir) / fname)


def animate_predictions(
    preds: np.ndarray,
    member_ids: list[str],
    out_dir: str | Path,
    label: str = "GNN",
) -> list[Path]:
    """GIFs for every target member: preds (time, member, height, ncells)
    (train_gnn.py:206-219 loop)."""
    out = []
    for m, mid in enumerate(member_ids):
        out.append(create_animation(preds[:, m], mid, out_dir, label=label))
    return out
