"""Batch sweep runner for the 2-D positional-encoding study (port of
``swnerf_tpu/experiments/autorun.py``, the reference's autorun): runs pos2d
over a grid of L / layer_num / regularization values; each run appends its
row to metrics.csv.

Usage: python -m swnerf_torch.experiments.autorun -pd image.png \
           [--Ls 0 5 10 20] [--layer_nums 4 10] [--regs 0 0.01] [--epochs 50] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools

from swnerf_torch.experiments.pos2d import main as pos2d_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--picture_dir", "-pd", required=True)
    ap.add_argument("--Ls", type=int, nargs="+", default=[0, 5, 10, 20])
    ap.add_argument("--layer_nums", type=int, nargs="+", default=[10])
    ap.add_argument("--regs", type=float, nargs="+", default=[0.0])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--output_dir", "-od", default="2d_pos_encoding/result")
    ap.add_argument("--checkpoint_save", "-cs", default="2d_pos_encoding/checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    for L, ln, reg in itertools.product(args.Ls, args.layer_nums, args.regs):
        print(f"=== sweep: L={L} layer_num={ln} reg={reg} ===")
        pos2d_main([
            "-pd", args.picture_dir, "--L", str(L), "--layer_num", str(ln), "--epochs", str(args.epochs),
            "--regularization", str(reg), "-od", args.output_dir, "-cs", args.checkpoint_save,
            "--device", args.device,
        ])


if __name__ == "__main__":
    main()
