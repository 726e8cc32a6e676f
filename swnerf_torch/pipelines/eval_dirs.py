"""Directory-vs-directory evaluation (port of
``swnerf_tpu/pipelines/eval_dirs.py``): MSE / PSNR / SSIM / LPIPS over
paired prediction and ground-truth image folders.

The script equivalent of the reference's d_nerf/metrics.ipynb (cells 1-6):
it walks two directories of same-named frames (e.g. ``renderonly_test_*/``
estim vs gt dumps), computes per-frame metrics, and writes ``metrics.txt`` +
``metrics.json``. LPIPS is LPIPS-vgg on the weights in ``SWNERF_LPIPS_DIR``
(``utils/lpips.py``), on ``--device``; null with a note without them.
Frames are read by ``utils/images.py::read_images``: PNG by the port's
reader, JPEG through cv2 (``NotImplementedError`` where cv2 is missing).

Usage: python -m swnerf_torch.pipelines.eval_dirs --pred DIR --gt DIR [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from swnerf_torch.device import resolve_device
from swnerf_torch.utils.images import read_images
from swnerf_torch.utils.metrics import LPIPS_UNAVAILABLE_NOTE, lpips, psnr, ssim


def _list_images(d: str):
    return sorted(f for f in os.listdir(d) if f.lower().endswith((".png", ".jpg", ".jpeg")))


def evaluate_dirs(pred_dir: str, gt_dir: str, device="cpu"):
    """Per-frame ``{"pred", "gt", "mse", "psnr", "ssim", "lpips"}`` for the
    sorted image names of the two directories, paired in order."""
    preds = _list_images(pred_dir)
    gts = _list_images(gt_dir)
    if len(preds) != len(gts):
        raise ValueError(f"frame count mismatch: {len(preds)} pred vs {len(gts)} gt")

    per_frame = []
    for pf, gf in zip(preds, gts):
        p8, g8 = read_images([os.path.join(pred_dir, pf), os.path.join(gt_dir, gf)])
        p = p8[..., :3].astype(np.float64) / 255.0
        g = g8[..., :3].astype(np.float64) / 255.0
        per_frame.append(
            {
                "pred": pf,
                "gt": gf,
                "mse": float(np.mean((p - g) ** 2)),
                "psnr": psnr(g, p, data_range=1.0),
                "ssim": ssim(g, p, data_range=1.0, win_size=7, channel_axis=2),
                # The d_nerf notebook's metric is LPIPS-vgg
                # (d_nerf/metrics.ipynb cell 4), unlike run.py's alex.
                "lpips": lpips(g, p, net="vgg", device=device),
            }
        )
    return per_frame


def main(argv=None):
    """The CLI; returns the per-frame metrics and their means."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--pred", required=True, help="directory of predicted frames")
    ap.add_argument("--gt", required=True, help="directory of ground-truth frames")
    ap.add_argument("--out", default=None, help="output dir (default: pred dir)")
    ap.add_argument("--device", default=None, help="LPIPS's device: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    frames = evaluate_dirs(args.pred, args.gt, resolve_device(args.device))
    out = args.out or args.pred
    os.makedirs(out, exist_ok=True)

    keys = ["mse", "psnr", "ssim", "lpips"]
    means = {
        k: (float(np.mean([f[k] for f in frames])) if all(f[k] is not None for f in frames) else None)
        for k in keys
    }
    payload = {"frames": frames, "mean": means}
    null_lpips = any(f["lpips"] is None for f in frames)
    if null_lpips:
        payload["lpips_note"] = LPIPS_UNAVAILABLE_NOTE
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(payload, f, indent=4)
    with open(os.path.join(out, "metrics.txt"), "w") as f:
        for k in keys:
            f.write(f"{k}: {means[k]}\n")
        if null_lpips:
            f.write(f"note: {LPIPS_UNAVAILABLE_NOTE}\n")
    print("mean:", means)
    return payload


if __name__ == "__main__":
    main()
