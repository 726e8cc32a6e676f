"""The port's 2-D positional-encoding study (``swnerf_torch/experiments/``)
against ``swnerf_tpu/experiments/pos2d.py`` on the CPU.

Bars: the encoding within 1e-6; one training step from the same weights and
batch (the JAX package's own parameters, loaded through the ``.npz`` leaf
order) within 1e-5: the loss, every parameter after the AdamW update, the
batch norms' running mean and variance. Random streams differ between the
packages, so both sides get the same weights and the same batch. The
``.npz`` files of either package load in the other exactly; the eval-mode
outputs agree within 1e-5. The tiny-image overfit of
``tests/test_misc.py::test_overfit_tiny_image`` on a PNG and on a JPEG, and a
two-run sweep through ``autorun``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from swnerf_torch.experiments import autorun, pos2d
from swnerf_tpu.experiments import pos2d as jax_pos2d

imageio = pytest.importorskip("imageio.v2")


def _grid(H=9, W=13):
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))
    return np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)


@pytest.mark.parametrize("L", [0, 3, 8])
def test_encode_matches_jax(L):
    pos = _grid()
    got = pos2d.encode(torch.from_numpy(pos), L).numpy()
    ref = np.asarray(jax_pos2d.encode(jnp.asarray(pos), L))
    assert got.shape == ref.shape == (pos.shape[0], 2 + 4 * L)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _jax_model(L, layer_num, seed=0):
    return jax_pos2d.init_model(jax.random.PRNGKey(seed), 2 + 4 * L, layer_num)


def _port_model(L, layer_num, params):
    model = pos2d.Pos2dMLP(2 + 4 * L, layer_num, device="cpu")
    model.load_leaves([np.asarray(x) for x in jax.tree.leaves(params)])
    return model


def _jax_step(params, bn_state, xb, yb, reg):
    """The JAX package's step (``pos2d.train``'s), at the schedule's first rate."""
    opt = optax.adamw(lambda step: 1e-3 * (0.95 ** (step // 4)))
    opt_state = opt.init(params)

    def loss_fn(p):
        out, new_bn = jax_pos2d.apply_model(p, bn_state, xb, train=True)
        mse = jnp.mean((out - yb) ** 2)
        return mse + jax_pos2d.clip_loss(out, reg), (new_bn, mse)

    (loss, (new_bn, mse)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = opt.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), new_bn, float(loss), float(mse)


@pytest.mark.parametrize("reg", [0.0, 0.5])
def test_one_step_matches_jax(reg):
    L, layer_num = 4, 2
    rng = np.random.default_rng(0)
    enc = np.asarray(jax_pos2d.encode(jnp.asarray(_grid(16, 16)), L))
    idx = rng.permutation(enc.shape[0])[:128]
    xb, yb = enc[idx], rng.uniform(-0.2, 1.2, (128, 3)).astype(np.float32)  # outside [0, 1]: the clip term
    params, bn_state = _jax_model(L, layer_num)
    model = _port_model(L, layer_num, params)
    opt, _ = pos2d.make_optimizer(model)

    new_params, new_bn, loss_ref, mse_ref = _jax_step(params, bn_state, jnp.asarray(xb), jnp.asarray(yb), reg)
    m = pos2d.train_step(model, opt, torch.from_numpy(xb), torch.from_numpy(yb), reg)

    assert abs(m["loss"].item() - loss_ref) <= 1e-5 * max(1.0, abs(loss_ref))
    assert abs(m["mse"].item() - mse_ref) <= 1e-5 * max(1.0, abs(mse_ref))
    for got, ref in zip(model.leaves(), jax.tree.leaves(new_params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for norm, st in zip(model.norms, new_bn):
        np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(st["mean"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(st["var"]), atol=1e-5, rtol=0)
    # the biased variance: nn.BatchNorm1d's unbiased update would miss by var / (n - 1)
    assert not np.allclose(model.norms[0].running_var.numpy(),
                           0.9 + 0.1 * np.var(np.maximum(xb @ np.asarray(params["layers"][0]["w"]), 0), 0,
                                              ddof=1), atol=1e-6)


def test_npz_reads_across_both_ways(tmp_path):
    L, layer_num = 2, 3
    params, bn_state = _jax_model(L, layer_num, seed=3)
    # the JAX package's file (pos2d.train's np.savez) into the port
    jax_file = tmp_path / "jax.npz"
    np.savez(jax_file, **{f"p_{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(params))})
    model = pos2d.Pos2dMLP(2 + 4 * L, layer_num, device="cpu")
    pos2d.load_npz(model, str(jax_file))
    for got, ref in zip(model.leaves(), jax.tree.leaves(params)):
        assert np.array_equal(got.detach().numpy(), np.asarray(ref))
    # the port's file into the JAX tree
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    port_file = tmp_path / "port.npz"
    pos2d.save_npz(model, str(port_file))
    with np.load(port_file) as f:
        leaves = [f[f"p_{i}"] for i in range(len(f.files))]
    tree = jax.tree.unflatten(jax.tree.structure(params), [jnp.asarray(x) for x in leaves])
    for got, ref in zip(jax.tree.leaves(tree), model.leaves()):
        assert np.array_equal(np.asarray(got), ref.detach().numpy())
    enc = np.asarray(jax_pos2d.encode(jnp.asarray(_grid()), L))
    ref_out = np.asarray(jax_pos2d.apply_model(tree, bn_state, jnp.asarray(enc), train=False)[0])
    model.eval()
    with torch.no_grad():
        got_out = model(torch.from_numpy(enc)).numpy()
    np.testing.assert_allclose(got_out, ref_out, atol=1e-5, rtol=0)


def _gradient_picture(path):
    yy, xx = np.meshgrid(np.linspace(0, 1, 16), np.linspace(0, 1, 16), indexing="ij")
    img = np.stack([xx, yy, 0.5 * (xx + yy)], -1)
    imageio.imwrite(path, (img * 255).astype(np.uint8), **({"quality": 95} if path.endswith(".jpg") else {}))


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_overfit_tiny_image(tmp_path, ext):
    """A few epochs on a smooth gradient image reach a decent PSNR and write
    the reconstruction, the checkpoint and metrics.csv (JPEG through cv2)."""
    if ext == "jpg":
        pytest.importorskip("cv2")
    pic = str(tmp_path / f"grad.{ext}")
    _gradient_picture(pic)
    out, ck = str(tmp_path / "result"), str(tmp_path / "ckpt")
    metrics = pos2d.main(["-pd", pic, "--L", "4", "--layer_num", "2", "--epochs", "120", "-od", out, "-cs", ck,
                          "--device", "cpu"])
    assert any(f.endswith(".png") for f in os.listdir(out))
    assert os.listdir(ck) == ["grad_4_2_0.npz"]
    last_psnr = float((tmp_path / "metrics.csv").read_text().strip().splitlines()[-1].split(",")[-1])
    assert last_psnr > 10.0 and metrics["PSNR"][-1] > metrics["PSNR"][0]


def test_autorun_sweep(tmp_path):
    pic = str(tmp_path / "grad.png")
    _gradient_picture(pic)
    autorun.main(["-pd", pic, "--Ls", "0", "2", "--layer_nums", "1", "--epochs", "2", "-od",
                  str(tmp_path / "result"), "-cs", str(tmp_path / "ckpt"), "--device", "cpu"])
    rows = (tmp_path / "metrics.csv").read_text().strip().splitlines()
    assert [r.split(",")[:4] for r in rows] == [["0", "2", "1", "0.0"], ["2", "2", "1", "0.0"]]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["grad_0_1_0.0.npz", "grad_2_1_0.0.npz"]
