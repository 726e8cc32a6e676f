"""LPIPS in swnerf_torch (``utils/lpips.py``) against the JAX package's
``utils/lpips_jax.py`` on the CPU, on seeded weights written in the two file
layouts the user supplies: a torchvision backbone state dict
(``features.N.*``) and the lpips package's heads (``linN.model.1.weight``);
then ``utils/metrics.py``'s ``lpips`` / ``calculate_metrics`` through
``SWNERF_LPIPS_DIR``.

Bar: 1e-5 absolute on the distance in fp32 (both sides run fp32
convolutions with other summation orders; measured 2e-8 to 4e-7)."""

import numpy as np
import pytest
import torch

from swnerf_torch.utils import lpips as lpips_torch
from swnerf_torch.utils import metrics
from swnerf_tpu.utils import lpips_jax

torch.set_num_threads(2)


def write_lpips_weights(d, net, seed=0):
    """Seeded backbone and head files for ``net`` in ``d``, named as
    ``SWNERF_LPIPS_DIR`` expects (He-scaled convs, so the taps stay alive;
    non-negative heads, as LPIPS's are)."""
    convs, feature_idx, taps, _ = lpips_torch.NETS[net]
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for (cin, cout, k, _, _), fi in zip(convs, feature_idx):
        sd[f"features.{fi}.weight"] = torch.randn((cout, cin, k, k), generator=g) * (2.0 / (cin * k * k)) ** 0.5
        sd[f"features.{fi}.bias"] = torch.randn((cout,), generator=g) * 0.01
    heads = {f"lin{i}.model.1.weight": torch.rand((1, convs[t][1], 1, 1), generator=g) for i, t in enumerate(taps)}
    bb, ln = lpips_torch.NET_FILES[net]
    torch.save(sd, str(d / bb))
    torch.save(heads, str(d / ln))


def _images(size, n=2, seed=1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("net,size", [("alex", 64), ("vgg", 32)])
def test_lpips_matches_jax(net, size, tmp_path):
    """Per image and on the batch mean, the port within 1e-5 of LPIPSJax on
    the same weight files."""
    write_lpips_weights(tmp_path, net)
    port = lpips_torch.LPIPS(net, weights_dir=str(tmp_path))
    ref = lpips_jax.LPIPSJax(net, weights_dir=str(tmp_path))
    a, b = _images(size)
    for i in range(len(a)):
        got, want = port.score(a[i], b[i]), ref(a[i], b[i])
        assert want > 0 and abs(got - want) <= 1e-5, (got, want)
    assert abs(port.score(a, b) - ref(a, b)) <= 1e-5
    assert port.score(a[0], a[0]) == 0.0


def test_lpips_forward_on_nchw_as_jax(tmp_path):
    """The module's forward on NCHW tensors against ``lpips_forward``: the
    distance per image."""
    write_lpips_weights(tmp_path, "alex", seed=3)
    port = lpips_torch.LPIPS("alex", weights_dir=str(tmp_path))
    ref = lpips_jax.LPIPSJax("alex", weights_dir=str(tmp_path))
    a, b = _images(64, n=3, seed=4)
    got = port(torch.from_numpy(a).permute(0, 3, 1, 2), torch.from_numpy(b).permute(0, 3, 1, 2)).numpy()
    want = np.asarray(lpips_jax.lpips_forward(ref.params, "alex", a.transpose(0, 3, 1, 2), b.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_lpips_explicit_paths_and_bad_heads(tmp_path):
    write_lpips_weights(tmp_path, "alex")
    a, b = _images(64, n=1)
    by_dir = lpips_torch.LPIPS("alex", weights_dir=str(tmp_path)).score(a, b)
    by_path = lpips_torch.LPIPS("alex", str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth")).score(a, b)
    assert by_dir == by_path
    torch.save({"lin0.model.1.weight": torch.ones(1, 64, 1, 1)}, str(tmp_path / "short.pth"))
    with pytest.raises(ValueError, match="linear heads"):
        lpips_torch.LPIPS("alex", str(tmp_path / "alexnet.pth"), str(tmp_path / "short.pth"))
    with pytest.raises(ValueError, match="squeeze"):
        lpips_torch.LPIPS("squeeze", weights_dir=str(tmp_path))


def test_metrics_lpips_through_env(tmp_path, monkeypatch):
    """``metrics.lpips`` and the third value of ``calculate_metrics`` use the
    weights in SWNERF_LPIPS_DIR (pred clipped to [0, 1]), and are None when
    the directory lacks the net's files or the variable is unset."""
    write_lpips_weights(tmp_path, "alex")
    a, b = _images(64, n=1)
    pred = b[0] * 1.2 - 0.1  # outside [0, 1]: clipped as the JAX package clips it
    monkeypatch.setenv("SWNERF_LPIPS_DIR", str(tmp_path))
    ref = lpips_jax.LPIPSJax("alex", weights_dir=str(tmp_path))(a[0], np.clip(pred, 0, 1))
    assert metrics.lpips_available("alex") and not metrics.lpips_available("vgg")
    assert abs(metrics.lpips(a[0], pred) - ref) <= 1e-5
    assert abs(metrics.calculate_metrics(a[0], pred)[2] - ref) <= 1e-5
    assert metrics.lpips(a[0], pred, net="vgg") is None
    monkeypatch.delenv("SWNERF_LPIPS_DIR")
    assert metrics.calculate_metrics(a[0], pred)[2] is None and not metrics.lpips_available("alex")
