"""Config-file-layered CLI (port of ``swnerf_tpu/utils/config.py``: the
vanilla parser and the dynamic-family parser), plus ``--device``.

``--config <txt>`` files of ``key = value`` lines become defaults and CLI
flags override them; ``#``/``;`` comments, bare-flag booleans and repeated
keys (last wins) behave as in the reference's configargparse usage.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse ``key = value`` lines; bare keys map to 'true'."""
    values: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", ";")):
                continue
            if "=" in line:
                key, _, val = line.partition("=")
                values[key.strip()] = val.strip()
            else:
                values[line] = "true"
    return values


_TRUE = {"true", "yes", "1", "on"}


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse + ``--config file`` defaults layering."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._config_arg_names: List[str] = []

    def add_argument(self, *args, **kwargs):  # type: ignore[override]
        is_config = kwargs.pop("is_config_file", False)
        action = super().add_argument(*args, **kwargs)
        if is_config:
            self._config_arg_names.append(action.dest)
        return action

    def _apply_file_values(self, values: Dict[str, str]) -> None:
        actions = {a.dest: a for a in self._actions}
        for key, raw in values.items():
            action = actions.get(key)
            if action is None:
                continue  # configargparse warns; unknown keys are skipped
            if isinstance(action, argparse._StoreTrueAction):
                action.default = raw.lower() in _TRUE
            elif isinstance(action, argparse._StoreFalseAction):
                action.default = raw.lower() not in _TRUE
            elif action.type is not None:
                try:
                    action.default = action.type(raw)
                except (TypeError, ValueError):
                    action.default = raw
            else:
                action.default = None if raw.lower() == "none" else raw

    def parse_args(self, args: Optional[Sequence[str]] = None, namespace=None):  # type: ignore[override]
        argv = list(sys.argv[1:] if args is None else args)
        for dest in self._config_arg_names:
            flag = "--" + dest
            for i, a in enumerate(argv):
                if a == flag and i + 1 < len(argv):
                    self._apply_file_values(parse_config_file(argv[i + 1]))
                elif a.startswith(flag + "="):
                    self._apply_file_values(parse_config_file(a.split("=", 1)[1]))
        return super().parse_args(argv, namespace)


def _add_base_flags(p: ConfigArgumentParser) -> None:
    """Flags common to both reference parsers (utils.py:16-99,101-237) and
    ``--device``."""
    p.add_argument("--config", is_config_file=True, help="config file path")
    p.add_argument("--expname", type=str, help="experiment name")
    p.add_argument("--basedir", type=str, default="./logs/", help="where to store ckpts and logs")
    p.add_argument("--datadir", type=str, default="./data/llff/fern", help="input data directory")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")

    # training
    p.add_argument("--netdepth", type=int, default=8, help="layers in network")
    p.add_argument("--netwidth", type=int, default=256, help="channels per layer")
    p.add_argument("--netdepth_fine", type=int, default=8, help="layers in fine network")
    p.add_argument("--netwidth_fine", type=int, default=256, help="channels per layer in fine network")
    p.add_argument("--N_rand", type=int, default=32 * 32 * 4, help="batch size (number of random rays per gradient step)")
    p.add_argument("--lrate", type=float, default=5e-4, help="learning rate")
    p.add_argument("--lrate_decay", type=int, default=250, help="exponential learning rate decay (in 1000 steps)")
    p.add_argument("--chunk", type=int, default=1024 * 32, help="number of rays processed in parallel")
    p.add_argument("--netchunk", type=int, default=1024 * 64, help="number of pts sent through network in parallel")
    p.add_argument("--no_batching", action="store_true", help="only take random rays from 1 image at a time")
    p.add_argument("--no_reload", action="store_true", help="do not reload weights from saved ckpt")
    p.add_argument("--ft_path", type=str, default=None, help="specific weights npy file to reload for coarse network")

    # rendering
    p.add_argument("--N_samples", type=int, default=64, help="number of coarse samples per ray")
    p.add_argument("--N_importance", type=int, default=0, help="number of additional fine samples per ray")
    p.add_argument("--perturb", type=float, default=1.0, help="0. for no jitter, 1. for jitter")
    p.add_argument("--use_viewdirs", action="store_true", help="use full 5D input instead of 3D")
    p.add_argument("--i_embed", type=int, default=0, help="0 for positional encoding, -1 for none")
    p.add_argument("--multires", type=int, default=10, help="log2 of max freq for positional encoding (3D location)")
    p.add_argument("--multires_views", type=int, default=4, help="log2 of max freq for positional encoding (2D direction)")
    p.add_argument("--raw_noise_std", type=float, default=0.0, help="std dev of noise added to regularize sigma_a output")
    p.add_argument("--render_only", action="store_true", help="do not optimize, reload weights and render out render_poses path")
    p.add_argument("--render_test", action="store_true", help="render the test set instead of render_poses path")
    p.add_argument("--render_factor", type=int, default=0, help="downsampling factor to speed up rendering")

    # curriculum
    p.add_argument("--precrop_iters", type=int, default=0, help="number of steps to train on central crops")
    p.add_argument("--precrop_frac", type=float, default=0.5, help="fraction of img taken for central crops")

    # dataset
    p.add_argument("--dataset_type", type=str, default="llff", help="llff / blender / deepvoxels / LINEMOD / custom")
    p.add_argument("--shape", type=str, default="greek", help="deepvoxels scene: armchair / cube / greek / vase")
    p.add_argument("--white_bkgd", action="store_true", help="render synthetic data on a white background")
    p.add_argument("--half_res", action="store_true", help="load blender data at half resolution")
    p.add_argument("--factor", type=int, default=8, help="downsample factor for LLFF images")
    p.add_argument("--no_ndc", action="store_true", help="do not use normalized device coordinates")
    p.add_argument("--lindisp", action="store_true", help="sample linearly in disparity rather than depth")
    p.add_argument("--spherify", action="store_true", help="set for spherical 360 scenes")
    p.add_argument("--llffhold", type=int, default=8, help="take every 1/N images as LLFF test set")


def config_parser() -> ConfigArgumentParser:
    """The vanilla-NeRF parser (reference utils.py:16-99): base flags,
    testskip default 8, the vanilla logging cadence and the mesh /
    metric-scale flags."""
    p = ConfigArgumentParser()
    _add_base_flags(p)
    p.add_argument("--testskip", type=int, default=8, help="load 1/N images from test/val sets")

    # logging cadence
    p.add_argument("--i_print", type=int, default=100, help="console printout frequency")
    p.add_argument("--i_img", type=int, default=500, help="tensorboard image log frequency")
    p.add_argument("--i_weights", type=int, default=10000, help="ckpt save frequency")
    p.add_argument("--i_testset", type=int, default=50000, help="testset save frequency")
    p.add_argument("--i_video", type=int, default=50000, help="render-poses video save frequency")

    # mesh extraction / metric-scale transform (SW pipeline)
    p.add_argument("--resolution", type=int, default=128, help="resolution of the mesh")
    p.add_argument("--threshold", type=int, default=8, help="density threshold of the mesh")
    p.add_argument("--real_length", type=float, default=0.005, help="real length of the aruco marker")
    return p


def config_parser_dnerf() -> ConfigArgumentParser:
    """The dynamic-family parser (reference utils.py:101-237): base flags,
    nerf_type / N_iter, half precision, the canonical-time and two-model
    switches, the time curriculum, the TV loss, and the dnerf logging
    cadence, and the multiresolution-pyramid flags of the MultiRes trainer."""
    p = ConfigArgumentParser()
    _add_base_flags(p)
    p.add_argument("--testskip", type=int, default=2, help="load 1/N images from test/val sets")

    p.add_argument("--nerf_type", type=str, default="original", help="nerf network type")
    p.add_argument("--N_iter", type=int, default=500000, help="num training iterations")
    p.add_argument("--do_half_precision", action="store_true", help="half precision training and inference")
    p.add_argument("--not_zero_canonical", action="store_true", help="if set zero time is not the canonic space")
    p.add_argument("--use_two_models_for_fine", action="store_true", help="use two models for fine results")
    p.add_argument("--precrop_iters_time", type=int, default=0, help="number of steps to train on central time")
    p.add_argument("--add_tv_loss", action="store_true", help="evaluate tv loss")
    p.add_argument("--tv_loss_weight", type=float, default=1.0e-4, help="weight of tv loss")

    # multiresolution pyramid options
    p.add_argument("--layer_num", type=int, default=4, help="number of resolutions")
    p.add_argument("--global_optimization_epoch", type=int, default=120)
    p.add_argument("--inner_iteration", type=int, default=10)
    p.add_argument("--loss_decrease_rate", type=float, default=0.04)

    p.add_argument("--i_print", type=int, default=1000, help="console printout frequency")
    p.add_argument("--i_img", type=int, default=5000, help="tensorboard image log frequency")
    p.add_argument("--i_weights", type=int, default=5000, help="ckpt save frequency")
    p.add_argument("--i_testset", type=int, default=40000, help="testset save frequency")
    p.add_argument("--i_video", type=int, default=40000, help="render-poses video save frequency")
    return p
