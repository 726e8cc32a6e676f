"""2-D positional-encoding study (port of ``swnerf_tpu/experiments/pos2d.py``):
fit an MLP to a single image from encoded (x, y), which shows why Fourier
features matter.

- encoding: coordinates scaled to [-1, 1] by the per-axis max, then
  ``[x, y, per frequency i: sin(2^i pi x), sin(2^i pi y), cos(2^i pi x),
  cos(2^i pi y)]``, the reference's interleave;
- model (:class:`Pos2dMLP`): ``layer_num`` x [Linear -> ReLU -> BatchNorm]
  and a Linear head; Xavier-uniform weights, zero biases. The batch norm
  keeps its running statistics as the JAX package does: the running
  variance moves toward the *biased* batch variance (``jnp.var``), where
  ``nn.BatchNorm1d`` would use the unbiased one;
- training: AdamW at 1e-3 with optax's default weight decay 1e-4 (torch's
  default is 1e-2), the rate times 0.95 after every epoch, batches of 512,
  MSE plus the clip regulariser ``mean(max(0, x - 1) + max(0, -x)) * reg``,
  the gray-luma PSNR, a ``metrics.csv`` row, reconstructions every 20
  epochs;
- the ``.npz`` checkpoint holds ``p_i`` in ``jax.tree.leaves`` order of the
  JAX package's parameter tree (``head`` then ``layers``; within each,
  ``b``, ``beta``, ``gamma``, ``w``; ``w`` as ``[in, out]``), so either
  package reads the other's file (``-cl`` loads one here).

The picture is read by ``utils/images.py::read_images`` (PNG, or JPEG
through cv2). Training runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from swnerf_torch.device import resolve_device

GRAY = (0.2989, 0.5870, 0.1140)
BATCH = 512


def load_picture(path: str):
    """Image -> ([H*W, 2] (x, y) positions, [H*W, 3] colours, W, H)."""
    from swnerf_torch.utils.images import read_images

    img = read_images([path])[0]
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] < 3:  # grayscale (and its alpha): the grey in every channel
        img = np.repeat(img[..., :1], 3, -1)
    img = img[..., :3].astype(np.float32) / 255.0
    H, W = img.shape[:2]
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    pos = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    return pos, img.reshape(-1, 3), W, H


def encode(pos: torch.Tensor, L: int) -> torch.Tensor:
    """[N, 2] -> [N, 4L + 2] with the reference's channel interleave."""
    pos = 2.0 * (pos / pos.max(0).values) - 1.0
    outs = [pos]
    for i in range(L):
        f = (2.0**i) * math.pi
        outs += [torch.sin(f * pos[:, :1]), torch.sin(f * pos[:, 1:2]),
                 torch.cos(f * pos[:, :1]), torch.cos(f * pos[:, 1:2])]
    return torch.cat(outs, -1)


class BatchNorm(nn.Module):
    """Batch norm over the rows with the JAX package's running statistics:
    ``(1 - momentum) * running + momentum * batch``, the batch variance
    biased."""

    def __init__(self, n: int, device=None, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.gamma = nn.Parameter(torch.ones(n, device=device))
        self.beta = nn.Parameter(torch.zeros(n, device=device))
        self.register_buffer("running_mean", torch.zeros(n, device=device))
        self.register_buffer("running_var", torch.ones(n, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = x.mean(0), x.var(0, correction=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) / torch.sqrt(var + self.eps) * self.gamma + self.beta


class Pos2dMLP(nn.Module):
    """``layer_num`` x [Linear -> ReLU -> BatchNorm], then a Linear head,
    on ``device``, Xavier-uniform weights drawn from ``generator``."""

    def __init__(self, input_dim: int, layer_num: int, hidden: int = 256, out_dim: int = 3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [input_dim] + [hidden] * layer_num
        self.linears = nn.ModuleList(self._linear(a, hidden, device, generator) for a in dims[:-1])
        self.norms = nn.ModuleList(BatchNorm(hidden, device) for _ in range(layer_num))
        self.head = self._linear(dims[-1], out_dim, device, generator)

    @staticmethod
    def _linear(fan_in: int, fan_out: int, device, generator) -> nn.Linear:
        lin = nn.utils.skip_init(nn.Linear, fan_in, fan_out, device=device)
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        gdev = generator.device if generator is not None else None
        w = torch.rand((fan_in, fan_out), generator=generator, device=gdev) * (2 * bound) - bound
        with torch.no_grad():
            lin.weight.copy_(w.t())
            lin.bias.zero_()
        return lin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin, norm in zip(self.linears, self.norms):
            x = norm(torch.relu(lin(x)))
        return self.head(x)

    def leaves(self) -> List[torch.Tensor]:
        """The parameters in ``jax.tree.leaves`` order of the JAX package's
        tree, each in its layout there (``w`` as ``[in, out]``)."""
        out = [self.head.bias, self.head.weight.t()]
        for lin, norm in zip(self.linears, self.norms):
            out += [lin.bias, norm.beta, norm.gamma, lin.weight.t()]
        return out

    @torch.no_grad()
    def load_leaves(self, arrays: List[np.ndarray]) -> None:
        """Set the parameters from :meth:`leaves`-ordered arrays."""
        mine = self.leaves()
        if len(arrays) != len(mine):
            raise ValueError(f"{len(arrays)} arrays for {len(mine)} parameters")
        for dst, src in zip(mine, arrays):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"shape {tuple(src.shape)} for a parameter of shape {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def save_npz(model: Pos2dMLP, path: str) -> None:
    np.savez(path, **{f"p_{i}": x.detach().cpu().numpy() for i, x in enumerate(model.leaves())})


def load_npz(model: Pos2dMLP, path: str) -> None:
    with np.load(path) as f:
        model.load_leaves([f[f"p_{i}"] for i in range(len(f.files))])


def clip_loss(x: torch.Tensor, reg: float) -> torch.Tensor:
    """Penalise outputs outside [0, 1] (reference utils.py:12-14)."""
    return torch.mean(torch.relu(x - 1.0) + torch.relu(-x)) * reg


def gray_psnr(mse_gray: float) -> float:
    return float(10.0 * np.log(1.0 / mse_gray) / np.log(10.0))


def make_optimizer(model: Pos2dMLP):
    """optax.adamw(1e-3)'s settings, and the per-epoch 0.95 decay."""
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    return opt, torch.optim.lr_scheduler.ExponentialLR(opt, 0.95)


def train_step(model: Pos2dMLP, opt, xb: torch.Tensor, yb: torch.Tensor, reg: float,
               gray: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One step on a batch: the loss's gradient, the running statistics, one
    AdamW update. Returns the batch's loss, mse and gray mse (on the
    device). ``gray``: the luma weights on the batch's device (made once by
    the caller: a copy from the host at every step would wait for it)."""
    model.train()
    out = model(xb)
    diff = out - yb
    mse = torch.mean(diff**2)
    gray = torch.tensor(GRAY, device=diff.device) if gray is None else gray
    gray_mse = torch.mean((diff @ gray) ** 2)
    loss = mse + clip_loss(out, reg)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "mse": mse.detach(), "gray_mse": gray_mse.detach()}


def train(args):
    dev = resolve_device(args.device)
    pos, colors, W, H = load_picture(args.picture_dir)
    enc = encode(torch.from_numpy(pos), args.L).to(dev)
    target = torch.from_numpy(colors).to(dev)
    n = enc.shape[0]

    g = torch.Generator().manual_seed(0)
    model = Pos2dMLP(2 + 4 * args.L, args.layer_num, device=dev, generator=g)
    if args.checkpoint_load:
        load_npz(model, args.checkpoint_load)
    opt, sched = make_optimizer(model)

    gray = torch.tensor(GRAY, device=dev)
    steps_per_epoch = max(n // BATCH, 1)
    host = np.random.default_rng(0)
    metrics = {"MSE": [], "PSNR": [], "seconds": []}
    t0 = time.time()
    for epoch in range(args.epochs):
        t_epoch = time.perf_counter()
        perm = torch.from_numpy(host.permutation(n)).to(dev)
        tot_mse = tot_gray = 0.0
        for b in range(steps_per_epoch):
            idx = perm[b * BATCH : (b + 1) * BATCH]
            m = train_step(model, opt, enc[idx], target[idx], args.regularization, gray)
            tot_mse = tot_mse + m["mse"]
            tot_gray = tot_gray + m["gray_mse"]
        sched.step()
        avg_mse = float(tot_mse) / steps_per_epoch  # one device sync an epoch
        psnr = gray_psnr(float(tot_gray) / steps_per_epoch)
        metrics["MSE"].append(avg_mse)
        metrics["PSNR"].append(psnr)
        metrics["seconds"].append(time.perf_counter() - t_epoch)
        if args.v:
            print(f"Epoch {epoch + 1}/{args.epochs} MSE: {avg_mse:.4f} PSNR: {psnr:.4f} time: {time.time() - t0:.2f}s")
        if (epoch + 1) % 20 == 0:
            reconstruct(model, enc, W, H, args, epoch + 1)

    stem = os.path.splitext(os.path.basename(args.picture_dir))[0]
    name = f"{stem}_{args.L}_{args.layer_num}_{args.regularization}"
    os.makedirs(args.checkpoint_save, exist_ok=True)
    save_npz(model, os.path.join(args.checkpoint_save, name + ".npz"))
    with open(os.path.join(os.path.dirname(args.output_dir) or ".", "metrics.csv"), "a") as f:
        f.write(f"{args.L},{args.epochs},{args.layer_num},{args.regularization},{metrics['PSNR'][-1]:.2f}\n")
    print(f"final mse: {metrics['MSE'][-1]}, final psnr: {metrics['PSNR'][-1]}")
    reconstruct(model, enc, W, H, args, args.epochs)
    return metrics


@torch.no_grad()
def reconstruct(model: Pos2dMLP, enc: torch.Tensor, W: int, H: int, args, tag) -> None:
    from swnerf_torch.utils.media import write_png

    model.eval()
    img = model(enc).clamp(0, 1).reshape(H, W, 3).cpu().numpy()
    stem = os.path.splitext(os.path.basename(args.picture_dir))[0]
    write_png(os.path.join(args.output_dir, f"{stem}_L{args.L}_e{tag}.png"), img)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The configs")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--layer_num", type=int, default=10)
    p.add_argument("--picture_dir", "-pd", type=str, required=True)
    p.add_argument("--L", type=int, default=20, help="dimension of positional encoding")
    p.add_argument("--checkpoint_save", "-cs", type=str, default="2d_pos_encoding/checkpoint")
    p.add_argument("--checkpoint_load", "-cl", type=str, default=None,
                   help="start from this .npz (written by either package)")
    p.add_argument("-v", action="store_true", help="Verbose mode")
    p.add_argument("--output_dir", "-od", type=str, default="2d_pos_encoding/result")
    p.add_argument("--regularization", "-reg", type=float, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    return train(args)


if __name__ == "__main__":
    main()
