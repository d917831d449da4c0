"""Image conversion, GIF and video writing, per-iteration image streams (a
copy of dbw_tpu/utils/image.py). Videos are encoded by imageio's ffmpeg
where it is installed; without it they degrade to a GIF of at most
MAX_GIF_FRAMES frames, with the JAX package's warning."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
from PIL import Image

from .logger import print_warning
from .misc import path_mkdir

MAX_GIF_SIZE = 256
# PIL palette-quantizes every GIF frame on one host core; the fallback
# strides to this many frames and scales the frame duration so that the
# playback time is kept
MAX_GIF_FRAMES = 60


def convert_to_img(arr):
    """(H, W, C) or (C, H, W) or (H, W) float [0,1] / uint8 -> PIL Image."""
    arr = np.asarray(arr)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.ndim == 3 and arr.shape[0] in (1, 3, 4) and arr.shape[0] < arr.shape[2]:
        arr = np.transpose(arr, (1, 2, 0))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(arr)


def _num_key(p):
    try:
        return (0, int(p.stem))
    except ValueError:
        return (1, p.stem)


def save_gif(src, name="out.gif", size=MAX_GIF_SIZE, in_ext="jpg", fps=24):
    """Directory of frames -> adaptive-palette GIF."""
    src = Path(src)
    files = sorted(src.glob(f"*.{in_ext}"), key=_num_key)
    if not files:
        return
    imgs = []
    for f in files:
        im = Image.open(f).convert("RGB")
        if max(im.size) > size:
            r = size / max(im.size)
            im = im.resize((int(im.width * r), int(im.height * r)))
        imgs.append(im)
    imgs[0].save(src.parent / name, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def save_video(src, name="out.mp4", in_ext="jpg", fps=24):
    """Directory of frames (or a (T, H, W, C) array) -> mp4 through
    imageio's ffmpeg, or a GIF beside it when no encoder is available."""
    if isinstance(src, (str, Path)):
        src = Path(src)
        files = sorted(src.glob(f"*.{in_ext}"), key=_num_key)
        frames = [np.asarray(Image.open(f).convert("RGB")) for f in files]
        out_path = src.parent / name
    else:
        frames = [np.asarray(convert_to_img(f)) for f in src]
        out_path = Path(name)
    if not frames:
        return
    try:
        import imageio.v2 as imageio

        with imageio.get_writer(out_path, fps=fps, codec="libx264") as w:
            for fr in frames:
                w.append_data(fr)
    except Exception as e:  # no imageio or no ffmpeg codec: the GIF
        print_warning(f"save_video: mp4 encode failed ({e}); writing GIF")
        stride = max(1, -(-len(frames) // MAX_GIF_FRAMES))
        pil = [Image.fromarray(f) for f in frames[::stride]]
        pil[0].save(out_path.with_suffix(".gif"), save_all=True,
                    append_images=pil[1:], duration=int(1000 * stride / fps),
                    loop=0)


class ImageLogger:
    """Per-sample image streams over the run (``imgK/evolution/<it>.<ext>``,
    ``imgK/input.png``, ``imgK/final.png``) and their final video."""

    def __init__(self, log_dir, target_images=None, n_images=1, out_ext="jpg"):
        self.log_dir = path_mkdir(log_dir)
        if target_images is not None:
            if isinstance(target_images, dict):
                target_images = target_images["imgs"]
            self.n_images = len(target_images)
        else:
            self.n_images = n_images
        for k in range(self.n_images):
            path_mkdir(self.log_dir / f"img{k}" / "evolution")
        if target_images is not None:
            for k, im in enumerate(target_images):
                convert_to_img(im).save(self.log_dir / f"img{k}" / "input.png")
        self.out_ext = out_ext

    def save(self, images, it=None):
        images = np.asarray(images)
        for k in range(min(len(images), self.n_images)):
            img = convert_to_img(images[k])
            if it is not None:
                img.save(self.log_dir / f"img{k}" / "evolution" / f"{it}.{self.out_ext}")
            else:
                img.save(self.log_dir / f"img{k}" / "final.png")

    def save_video(self, rmtree=True):
        for k in range(self.n_images):
            evo = self.log_dir / f"img{k}" / "evolution"
            save_video(evo, "evolution.mp4", in_ext=self.out_ext)
            if rmtree:
                shutil.rmtree(str(evo), ignore_errors=True)
