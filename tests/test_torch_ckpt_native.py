"""The native checkpoint format in swnerf_torch against swnerf_tpu on the CPU:
the port's msgpack codec (``utils/msgpack.py``) against flax's, native
snapshots written by either package and resumed by the other for every
trainer's payload (vanilla, T-NeRF, D-NeRF with one and two models,
MultiRes), the ``SWNERF_CKPT_FORMAT`` switch and the checkpoint listing
against the JAX package's, and each trainer CLI saving both formats and
resuming from the ``.msgpack`` alone.

Bars: exact. Weights, Adam moments and counts are moved, not computed, so
every comparison is bit for bit (``np.array_equal`` / ``torch.equal``); the
JAX states are seeded with numpy and taken three Adam updates in (seeded
random gradients), so moments and counts are populated."""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack as msgpack_pkg
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from swnerf_torch.models import DirectTemporalNeRF, DNeRFConfig, TNeRF, TNeRFConfig, VanillaNeRF, VanillaNeRFConfig
from swnerf_torch.pipelines import run_dnerf, run_multires, run_nerf, run_tnerf
from swnerf_torch.pipelines.run_multires import native_multires, restore_native_multires
from swnerf_torch.train import checkpoint as ck
from swnerf_torch.train.loop import init_train_state
from swnerf_torch.utils import msgpack
from swnerf_tpu.data.synthetic import write_blender_scene
from swnerf_tpu.models.dnerf import DNeRFConfig as JaxDNeRFConfig
from swnerf_tpu.models.dnerf import make_dnerf_field
from swnerf_tpu.models.tnerf import TNeRFConfig as JaxTNeRFConfig
from swnerf_tpu.models.tnerf import init_tnerf_params
from swnerf_tpu.models.vanilla import VanillaNeRFConfig as JaxVanillaConfig
from swnerf_tpu.models.vanilla import init_vanilla_params
from swnerf_tpu.train import checkpoint as jck
from swnerf_tpu.train.loop import init_train_state as jax_init_train_state
from swnerf_tpu.train.loop import make_optimizer as jax_make_optimizer

torch.set_num_threads(2)

VANILLA = dict(netdepth=2, netwidth=32, skips=(4,), multires=2, multires_views=1, use_viewdirs=True, output_ch=5)
TNERF = dict(netdepth=2, net_dim=32, skip_layer=4, multires=2, multires_views=1)
DNERF = dict(netdepth=2, netwidth=32, skips=(4,), multires=2, multires_views=1, use_viewdirs=True, output_ch=5)
LEVELS = ((2, 1, 2), (1, 1, 1))  # (multires, multires_views, multires_time) of two MultiRes levels
FAMILIES = ["vanilla", "tnerf", "dnerf1", "dnerf2", "multires"]


# ---------------------------------------------------------------- the JAX side and the port's side of each family


def _adam_steps(params, n=3, seed=0):
    """The JAX package's optimizer ``n`` updates into ``params`` on seeded
    random gradients: (params, opt_state)."""
    opt = jax_make_optimizer(5e-4, 250)
    state = opt.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), params)
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def _jax_params(family, key):
    """One level's ``{"coarse", "fine"}`` JAX params."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    if family == "vanilla":
        cfg = JaxVanillaConfig(**VANILLA)
        return {"coarse": init_vanilla_params(k1, cfg), "fine": init_vanilla_params(k2, cfg)}
    if family == "tnerf":
        return {"coarse": init_tnerf_params(k1, JaxTNeRFConfig(**TNERF)), "fine": None}
    levels = dict(zip(("multires", "multires_views", "multires_time"), LEVELS[key % 2])) if family == "multires" \
        else {}
    field = make_dnerf_field(JaxDNeRFConfig(**{**DNERF, **levels}), fused=False)
    return {"coarse": field.init(k1), "fine": field.init(k2) if family == "dnerf2" else None}


def _jax_snapshot(family):
    """(the JAX package's state as its trainer saves it, the template its
    trainer loads into): a TrainState, or MultiRes's {"params_all",
    "opt_states"}."""
    if family == "multires":
        levels = [_adam_steps(_jax_params(family, l), seed=l) for l in range(2)]
        fresh = [_jax_params(family, l) for l in range(2)]
        opt = jax_make_optimizer(5e-4, 250)
        return ({"params_all": [p for p, _ in levels], "opt_states": [s for _, s in levels]},
                {"params_all": fresh, "opt_states": [opt.init(p) for p in fresh]})
    params, opt_state = _adam_steps(_jax_params(family, 0))
    state = jax_init_train_state(params, jax_make_optimizer(5e-4, 250))._replace(
        step=jnp.asarray(3, jnp.int32), opt_state=opt_state)
    return state, jax_init_train_state(_jax_params(family, 0), jax_make_optimizer(5e-4, 250))


def _port_model(family, level=0):
    if family == "vanilla":
        return VanillaNeRF(VanillaNeRFConfig(**VANILLA), device="cpu")
    if family == "tnerf":
        return TNeRF(TNeRFConfig(**TNERF), device="cpu")
    levels = dict(zip(("multires", "multires_views", "multires_time"), LEVELS[level])) if family == "multires" \
        else {}
    return DirectTemporalNeRF(DNeRFConfig(**{**DNERF, **levels}), device="cpu", fused=False)


def _port_states(family):
    """The port's TrainStates (one, or one per MultiRes level)."""
    if family == "multires":
        return [init_train_state(_port_model(family, l), None) for l in range(2)]
    two = family in ("vanilla", "dnerf2")
    return [init_train_state(_port_model(family), _port_model(family) if two else None)]


def _port_template(family, states):
    return native_multires(states) if family == "multires" else ck.native_state(states[0])


def _restore(family, states, saved):
    if family == "multires":
        restore_native_multires(states, saved)
    else:
        ck.restore_native_state(states[0], saved)


def _jax_levels(family, jstate):
    """[(params {"coarse", "fine"}, scale_by_adam state)] of each level."""
    if family == "multires":
        return [(p, s[0]) for p, s in zip(jstate["params_all"], jstate["opt_states"])]
    return [(jstate.params, jstate.opt_state[0])]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_port_holds(states, levels):
    """Each port state's weights bit-equal to params_from_jax of the JAX
    params, its Adam moments to mu / nu and its counts to count."""
    for st, (params, adam) in zip(states, levels):
        count = int(adam.count)
        for model, net in zip((st.coarse, st.fine), ("coarse", "fine")):
            if model is None:
                assert params[net] is None
                continue
            ref = ck.params_from_jax(_np(params[net]))
            assert list(model.state_dict()) == list(ref)
            for k, v in model.state_dict().items():
                assert torch.equal(v, ref[k]), (net, k)
        names = [(net, k) for model, net in zip((st.coarse, st.fine), ("coarse", "fine")) if model is not None
                 for k in model.state_dict()]
        mu = {net: ck.params_from_jax(_np(adam.mu[net])) for net in ("coarse", "fine") if params[net] is not None}
        nu = {net: ck.params_from_jax(_np(adam.nu[net])) for net in ("coarse", "fine") if params[net] is not None}
        osd = st.optimizer.state_dict()["state"]
        assert len(osd) == len(names)
        for idx, (net, k) in enumerate(names):
            assert torch.equal(osd[idx]["exp_avg"], mu[net][k]), (net, k)
            assert torch.equal(osd[idx]["exp_avg_sq"], nu[net][k]), (net, k)
            assert int(osd[idx]["step"]) == count


# ---------------------------------------------------------------- the codec


@pytest.fixture(scope="module")
def jax_vanilla_blob(tmp_path_factory):
    path = tmp_path_factory.mktemp("blob") / "000003.msgpack"
    state, _ = _jax_snapshot("vanilla")
    jck.save_native(str(path), state, extra={"global_step": 3})
    return path.read_bytes()


def _assert_same_tree(a, b, path="root"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_codec_decodes_jax_snapshot_as_flax(jax_vanilla_blob):
    """Every leaf of a JAX ``save_native`` file decodes bit-equal to
    ``flax.serialization.msgpack_restore``'s, with its dtype and shape."""
    _assert_same_tree(msgpack.unpackb(jax_vanilla_blob), serialization.msgpack_restore(jax_vanilla_blob))


def test_codec_encoding_restores_through_flax(jax_vanilla_blob):
    """The port's encoding of the decoded snapshot restores through flax
    unchanged (and is byte-equal to the file: the same shortest forms)."""
    tree = msgpack.unpackb(jax_vanilla_blob)
    blob = msgpack.packb(tree)
    _assert_same_tree(serialization.msgpack_restore(blob), serialization.msgpack_restore(jax_vanilla_blob))
    assert blob == jax_vanilla_blob


VALUES = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129, -2**15 - 1,
          -2**31 - 1, -2**63, 1.5, -0.0, "", "x" * 31, "y" * 32, "z" * 300, "w" * 70000, b"", b"a" * 300,
          b"b" * 70000, [1] * 15, [1] * 16, [2] * 70000, {str(i): i for i in range(20)}, None, True, False,
          {"a": [1, {"b": None}], "c": b"\x00"}]


@pytest.mark.parametrize("value", VALUES, ids=range(len(VALUES)))
def test_codec_matches_msgpack_package(value):
    """Each kind of value packs to the msgpack package's bytes and decodes
    its bytes back (maps, arrays, ints at every width, floats, str, bin,
    bool, nil)."""
    blob = msgpack_pkg.packb(value, use_bin_type=True)
    assert msgpack.packb(value) == blob
    assert msgpack.unpackb(blob) == msgpack_pkg.unpackb(blob, raw=False, strict_map_key=False)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "bool", "uint8"])
@pytest.mark.parametrize("shape", [(), (3,), (2, 5)])
def test_codec_arrays_as_flax(dtype, shape):
    """flax's ext type 1 for every dtype the snapshots hold, 0-d included:
    byte-equal to flax's encoding, and both decoders agree."""
    x = np.random.default_rng(0).uniform(-3, 3, shape).astype(dtype)
    blob = serialization.msgpack_serialize({"x": x})
    assert msgpack.packb({"x": x}) == blob
    got = msgpack.unpackb(blob)["x"]
    assert got.dtype == x.dtype and got.shape == x.shape and got.tobytes() == x.tobytes()


def test_codec_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="ext type 3"):
        msgpack.unpackb(msgpack_pkg.packb(msgpack_pkg.ExtType(3, b"abc")))
    with pytest.raises(ValueError, match="float64"):
        msgpack.unpackb(serialization.msgpack_serialize({"x": np.zeros(2, np.float64)}))
    with pytest.raises(ValueError, match="float64"):
        msgpack.packb(np.zeros(2, np.float64))


# ---------------------------------------------------------------- snapshots both ways


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_snapshot_resumes_in_port(family, tmp_path):
    """A JAX state three Adam updates in, saved by the JAX ``save_native``,
    resumes in the port: weights bit-equal to ``params_from_jax``, Adam's
    moments to mu / nu and its step to count."""
    jstate, _ = _jax_snapshot(family)
    path = str(tmp_path / "000003.msgpack")
    jck.save_native(path, jstate, extra={"global_step": 3})
    states = _port_states(family)
    saved, extra = ck.load_native(path, _port_template(family, states), {"global_step": 0})
    assert extra == {"global_step": 3}
    _restore(family, states, saved)
    _assert_port_holds(states, _jax_levels(family, jstate))
    if family != "multires":
        assert states[0].step == 3


@pytest.mark.parametrize("family", FAMILIES)
def test_port_snapshot_loads_in_jax(family, tmp_path):
    """The port's snapshot of a state (its weights and Adam bridged from a
    JAX state) loads through the JAX ``load_native`` into the JAX template
    and equals the port's tensors, leaf for leaf."""
    jstate, template = _jax_snapshot(family)
    src = str(tmp_path / "jax.msgpack")
    jck.save_native(src, jstate, extra={"global_step": 3})
    states = _port_states(family)
    _restore(family, states, ck.load_native(src, _port_template(family, states), {"global_step": 0})[0])
    path = str(tmp_path / "000003.msgpack")
    ck.save_native(path, _port_template(family, states), extra={"global_step": 3})
    loaded, extra = jck.load_native(path, template, {"global_step": 0})
    assert extra == {"global_step": 3}
    _assert_port_holds(states, _jax_levels(family, loaded))
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("family,other", [("vanilla", "tnerf"), ("tnerf", "dnerf1"), ("dnerf1", "dnerf2"),
                                          ("dnerf2", "vanilla"), ("multires", "vanilla"), ("vanilla", "multires")])
def test_snapshot_of_another_family_raises(family, other, tmp_path):
    """A snapshot of another family (or of one model where two are
    trained) raises ValueError naming the file and where it differs."""
    jstate, _ = _jax_snapshot(other)
    path = str(tmp_path / "000003.msgpack")
    jck.save_native(path, jstate, extra={"global_step": 3})
    states = _port_states(family)
    with pytest.raises(ValueError, match="native checkpoint mismatch at snapshot"):
        ck.load_native(path, _port_template(family, states), {"global_step": 0})


def test_snapshot_of_another_width_raises(tmp_path):
    path = str(tmp_path / "000003.msgpack")
    ck.save_native(path, ck.native_state(_port_states("vanilla")[0]), {"global_step": 3})
    other = init_train_state(VanillaNeRF(VanillaNeRFConfig(**{**VANILLA, "netwidth": 16}), device="cpu"), None)
    with pytest.raises(ValueError, match=r"000003\.msgpack.*mismatch"):
        ck.load_native(path, ck.native_state(other), {"global_step": 0})


def test_params_to_jax_inverts_params_from_jax():
    """params_to_jax(params_from_jax(tree)) is the JAX tree, for each family
    and for a list of levels."""
    for family in ("vanilla", "tnerf", "dnerf1"):
        tree = _np(_jax_params(family, 0)["coarse"])
        back = ck.params_to_jax(ck.params_from_jax(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert np.array_equal(a, b) and a.dtype == b.dtype
    trees = [_np(_jax_params("multires", l)["coarse"]) for l in range(2)]
    back = ck.params_to_jax(ck.params_from_jax(trees))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(trees)))


# ---------------------------------------------------------------- the switch and the listing


@pytest.mark.parametrize("value", [None, "tar", "native", "both", "TAR", "tar,native", "native, tar"])
def test_ckpt_formats_as_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("SWNERF_CKPT_FORMAT", raising=False)
    else:
        monkeypatch.setenv("SWNERF_CKPT_FORMAT", value)
    assert ck.ckpt_formats() == jck.ckpt_formats()
    assert ("tar" in ck.ckpt_formats()) == jck.tar_enabled()


@pytest.mark.parametrize("value", ["tarr", "", ",", "tar,zip"])
def test_ckpt_format_typo_raises_as_jax(value, monkeypatch):
    monkeypatch.setenv("SWNERF_CKPT_FORMAT", value)
    with pytest.raises(ValueError) as port:
        ck.ckpt_formats()
    with pytest.raises(ValueError) as ref:
        jck.ckpt_formats()
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("value", ["orbax", "all", "tar,orbax"])
def test_orbax_refused_naming_roadmap(value, monkeypatch):
    monkeypatch.setenv("SWNERF_CKPT_FORMAT", value)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ck.ckpt_formats()


def test_find_checkpoints_orders_as_jax(tmp_path):
    """.tar, .msgpack and .orbax by iteration number (1000000 after 990000),
    a .tar after its same-iteration siblings, .tmp left out."""
    exp = tmp_path / "exp"
    exp.mkdir()
    for name in ("990000.tar", "1000000.tar", "1000000.msgpack", "990000.msgpack", "000010.orbax",
                 "000020.msgpack", "000020.tar", "000030.msgpack.tmp", "000040.tar.123.tmp", "best.tar",
                 "args.txt", "metrics.jsonl"):
        (exp / name).mkdir() if name.endswith(".orbax") else (exp / name).write_bytes(b"")
    got = ck.find_checkpoints(str(tmp_path), "exp")
    assert got == jck.find_checkpoints(str(tmp_path), "exp")
    assert [Path(p).name for p in got] == ["best.tar", "000010.orbax", "000020.msgpack", "000020.tar",
                                          "990000.msgpack", "990000.tar", "1000000.msgpack", "1000000.tar"]
    assert ck.find_checkpoints(str(tmp_path), "exp", "x.tar") == ["x.tar"]
    assert ck.find_checkpoints(str(tmp_path), "none") == []


def test_newest_orbax_raises_without_falling_back(tmp_path):
    exp = tmp_path / "exp"
    exp.mkdir()
    (exp / "000010.tar").write_bytes(b"")
    (exp / "000020.orbax").mkdir()
    ckpts = ck.find_checkpoints(str(tmp_path), "exp")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ck.try_native_resume(ckpts, False, dict)
    assert ck.try_native_resume(ckpts, True, dict) is None
    assert ck.try_native_resume(ckpts[:1], False, dict) is None


# ---------------------------------------------------------------- the trainers


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    write_blender_scene(str(root / "static"), n_train=3, n_val=1, n_test=1, size=16)
    write_blender_scene(str(root / "dynamic"), n_train=4, n_val=1, n_test=1, size=16, dynamic=True)
    return root


def _trainer(name, scenes, logs):
    common = ["--expname", "n", "--basedir", str(logs), "--dataset_type", "blender", "--white_bkgd",
              "--use_viewdirs", "--multires", "2", "--multires_views", "1", "--N_samples", "8", "--chunk", "128",
              "--i_weights", "4", "--i_print", "2", "--i_video", "100000", "--i_testset", "100000",
              "--testskip", "1", "--device", "cpu"]
    if name == "nerf":
        return run_nerf.main, common + ["--datadir", str(scenes / "static"), "--netdepth", "2", "--netwidth", "32",
                                        "--netdepth_fine", "2", "--netwidth_fine", "32", "--N_rand", "16",
                                        "--N_importance", "8", "--precrop_iters", "0"]
    dyn = common + ["--datadir", str(scenes / "dynamic"), "--netdepth", "2", "--netwidth", "32", "--N_rand", "8",
                    "--raw_noise_std", "1", "--i_img", "100000"]
    if name == "tnerf":
        return run_tnerf.main, dyn
    if name == "dnerf":
        return run_dnerf.main, dyn + ["--nerf_type", "direct_temporal", "--use_two_models_for_fine",
                                      "--N_importance", "8", "--add_tv_loss"]
    return run_multires.main, dyn + ["--nerf_type", "direct_temporal", "--layer_num", "2",
                                     "--global_optimization_epoch", "6", "--no_batching"]


def _tensors(path):
    """Every weight, Adam moment and count of a .tar or a .msgpack, as the
    port's state dicts: {(net, name): tensor}."""
    if path.suffix == ".tar":
        ckpt = ck.load_tar(str(path))
        out = {}
        for key, sd in ckpt.items():
            if key.startswith("network"):
                out.update({(key.replace("_state_dict", ""), k): v for k, v in sd.items()})
            elif key.startswith("optimizer"):
                for idx, ent in sd["state"].items():
                    for f in ("exp_avg", "exp_avg_sq"):
                        out[(key.replace("_state_dict", ""), idx, f)] = ent[f]
                    out[(key.replace("_state_dict", ""), idx, "step")] = torch.as_tensor(float(ent["step"]))
        return out
    raw, _ = msgpack.unpackb(path.read_bytes()), None
    state = raw["state"]
    levels = ([(str(l), state["params_all"][str(l)], state["opt_states"][str(l)]) for l in range(len(state["params_all"]))]
              if "params_all" in state else [(None, state["params"], state["opt_state"])])
    out = {}
    for l, params, opt in levels:
        suffix = "" if l is None else f"_{l}"
        keys = [k for k in ("coarse", "fine") if params[k] is not None]
        for k, net in zip(keys, ("network_fn", "network_fine")):
            out.update({(net + suffix, n): v for n, v in ck.params_from_jax(params[k]).items()})
        topt = ck.adam_to_torch_dict(opt["0"], params)
        opt_key = "optimizer" if l is None else f"optimizer_{l}"
        for idx, ent in topt["state"].items():
            out[(opt_key, idx, "exp_avg")] = ent["exp_avg"]
            out[(opt_key, idx, "exp_avg_sq")] = ent["exp_avg_sq"]
            out[(opt_key, idx, "step")] = ent["step"]
    return out


def _records(exp):
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ("t", "steps_per_sec", "ray_samples_per_sec_per_chip")}
            for r in recs]


@pytest.mark.parametrize("trainer", ["nerf", "tnerf", "dnerf", "multires"])
def test_trainer_saves_both_and_resumes_from_msgpack(trainer, scenes, tmp_path, monkeypatch, capsys):
    """Each trainer under SWNERF_CKPT_FORMAT=both for 8 steps (save 4):
    the .tar and the .msgpack of steps 4 and 8 hold the same weights, Adam
    moments and counts bit for bit; resumed for 4 more steps from the
    .msgpack alone (the .tar moved away) it ends bit-equal to the resume
    from the .tar (checkpoint and metrics.jsonl)."""
    monkeypatch.setenv("SWNERF_PHASE1_ITERS", "2")
    main, argv = _trainer(trainer, scenes, tmp_path / "a")
    monkeypatch.setenv("SWNERF_CKPT_FORMAT", "both")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "9")
    main(argv)
    exp = tmp_path / "a" / "n"
    assert sorted(p.name for p in exp.iterdir() if p.suffix in (".tar", ".msgpack")) == [
        "000004.msgpack", "000004.tar", "000008.msgpack", "000008.tar"]
    for it in ("000004", "000008"):
        a, b = _tensors(exp / f"{it}.tar"), _tensors(exp / f"{it}.msgpack")
        assert set(a) == set(b)
        assert all(torch.equal(a[k].float(), b[k].float()) for k in a), it
    resumed = {}
    for fmt in ("tar", "msgpack"):
        logs = tmp_path / f"resume_{fmt}"
        shutil.copytree(exp, logs / "n")
        (logs / "n" / ("000008.tar" if fmt == "msgpack" else "000008.msgpack")).unlink()
        (logs / "n" / "metrics.jsonl").unlink()
        monkeypatch.setenv("SWNERF_CKPT_FORMAT", "tar")
        monkeypatch.setenv("SWNERF_MAX_ITERS", "13")
        main(_trainer(trainer, scenes, logs)[1])
        out = capsys.readouterr().out
        assert f"Reloading from {logs / 'n' / ('000008.' + fmt)}" in out
        resumed[fmt] = (_tensors(logs / "n" / "000012.tar"), _records(logs / "n"))
    (ta, ra), (tb, rb) = resumed["tar"], resumed["msgpack"]
    assert set(ta) == set(tb) and all(torch.equal(ta[k], tb[k]) for k in ta)
    assert ra == rb and ra


def test_trainer_refuses_orbax_at_start_up(scenes, tmp_path, monkeypatch):
    main, argv = _trainer("nerf", scenes, tmp_path)
    monkeypatch.setenv("SWNERF_CKPT_FORMAT", "all")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        main(argv)
    assert not (tmp_path / "n" / "metrics.jsonl").exists()


def test_native_only_writes_no_tar(scenes, tmp_path, monkeypatch):
    main, argv = _trainer("nerf", scenes, tmp_path)
    monkeypatch.setenv("SWNERF_CKPT_FORMAT", "native")
    monkeypatch.setenv("SWNERF_MAX_ITERS", "5")
    main(argv)
    assert sorted(p.name for p in (tmp_path / "n").iterdir() if p.suffix in (".tar", ".msgpack")) == [
        "000004.msgpack"]
