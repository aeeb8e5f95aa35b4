"""JAX parameter trees -> this package's state dicts.

The inverse of ``selfpose3d_tpu/convert/torch2jax.py``. It takes the JAX
``{"params", "batch_stats"}`` trees as nested dicts of arrays and returns
the state dict of this package's modules, whose names are the
reference's torch names:
  * conv kernels (*k, I, O) -> (O, I, *k);
  * ConvTranspose kernels are spatially un-flipped, (*k, I, O) -> (I, O, *k)
    (flax applies the flipped kernel: torch2jax.py:30-34, v2v_net.py:132);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var.

The conversion is linear in the parameters (transposes and flips only), so
applied to a JAX **gradient** tree it yields this package's gradients
under the same names (``batch_stats`` may be left out then).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def conv_weight(k) -> torch.Tensor:
    """flax Conv kernel (*k, I, O) -> torch (O, I, *k)."""
    k = _np(k)
    nd = k.ndim
    return torch.from_numpy(np.ascontiguousarray(k.transpose(nd - 1, nd - 2, *range(nd - 2))))


def conv_transpose_weight(k) -> torch.Tensor:
    """flax ConvTranspose kernel (*k_flipped, I, O) -> torch (I, O, *k)."""
    k = _np(k)
    nd = k.ndim
    k = k[(slice(None, None, -1),) * (nd - 2)]
    return torch.from_numpy(np.ascontiguousarray(k.transpose(nd - 2, nd - 1, *range(nd - 2))))


class _Writer:
    def __init__(self, params: Mapping, stats: Mapping):
        self.params, self.stats, self.sd = params, stats, {}

    @staticmethod
    def _get(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def conv(self, path, name, transpose=False):
        node = self._get(self.params, path)
        fn = conv_transpose_weight if transpose else conv_weight
        self.sd[f"{name}.weight"] = fn(node["kernel"])
        if "bias" in node:
            self.sd[f"{name}.bias"] = torch.from_numpy(_np(node["bias"]))

    def bn(self, path, name):
        p = self._get(self.params, path)
        leaves = [("weight", p["scale"]), ("bias", p["bias"])]
        if self.stats:
            s = self._get(self.stats, path)
            leaves += [("running_mean", s["mean"]), ("running_var", s["var"])]
            self.sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        for leaf, src in leaves:
            self.sd[f"{name}.{leaf}"] = torch.from_numpy(_np(src).copy())


def pose_resnet_state_dict(params: Mapping, stats: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX PoseResNet trees -> ``PoseResNet`` state dict."""
    w = _Writer(params, stats)
    w.conv(("conv1",), f"{prefix}conv1")
    w.bn(("bn1",), f"{prefix}bn1")
    for key in params:
        if key.startswith("layer"):
            stage, block = key[len("layer"):].split("_")
            base = f"{prefix}layer{stage}.{block}"
            for sub in params[key]:
                if sub.startswith("conv"):
                    w.conv((key, sub), f"{base}.{sub}")
                elif sub.startswith("bn"):
                    w.bn((key, sub), f"{base}.{sub}")
                elif sub == "downsample_conv":
                    w.conv((key, sub), f"{base}.downsample.0")
                elif sub == "downsample_bn":
                    w.bn((key, sub), f"{base}.downsample.1")
        elif key.startswith("deconv_bn"):
            i = int(key[len("deconv_bn"):])
            w.bn((key,), f"{prefix}deconv_layers.{3 * i + 1}")
        elif key.startswith("deconv"):
            i = int(key[len("deconv"):])
            w.conv((key,), f"{prefix}deconv_layers.{3 * i}", transpose=True)
    w.conv(("final_layer",), f"{prefix}final_layer")
    return w.sd


def _res(w: _Writer, path, name):
    node = w._get(w.params, path)
    for sub, idx in (("conv1", "res_branch.0"), ("conv2", "res_branch.3")):
        w.conv(path + (sub,), f"{name}.{idx}")
    for sub, idx in (("bn1", "res_branch.1"), ("bn2", "res_branch.4")):
        w.bn(path + (sub,), f"{name}.{idx}")
    if "skip_conv" in node:
        w.conv(path + ("skip_conv",), f"{name}.skip_con.0")
        w.bn(path + ("skip_bn",), f"{name}.skip_con.1")


def v2v_state_dict(params: Mapping, stats: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX V2VNet trees -> ``V2VNet`` state dict."""
    w = _Writer(params, stats)
    w.conv(("front_basic", "conv"), f"{prefix}front_layers.0.block.0")
    w.bn(("front_basic", "bn"), f"{prefix}front_layers.0.block.1")
    _res(w, ("front_res",), f"{prefix}front_layers.1")
    for name in params["encoder_decoder"]:
        path = ("encoder_decoder", name)
        base = f"{prefix}encoder_decoder.{name}"
        if "upsample" in name:
            w.conv(path + ("deconv",), f"{base}.block.0", transpose=True)
            w.bn(path + ("bn",), f"{base}.block.1")
        else:
            _res(w, path, base)
    w.conv(("output_layer",), f"{prefix}output_layer")
    return w.sd


def from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MultiPersonPoseNetSSV`` variables -> ``MultiPersonPoseNetSSV``
    state dict (backbone, attn, root_net, pose_net). Without
    ``batch_stats`` (a gradient tree) only the parameters' names appear."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def sub(*path):
        node = stats
        for p in path:
            node = node.get(p, {}) if node else {}
        return node

    sd = {}
    if "backbone" in params:
        sd.update(pose_resnet_state_dict(params["backbone"], sub("backbone"), "backbone."))
    if "attn" in params:
        sd.update(pose_resnet_state_dict(
            params["attn"]["backbone"], sub("attn", "backbone"), "attn.backbone."
        ))
    for net in ("root_net", "pose_net"):
        if net in params:
            sd.update(v2v_state_dict(
                params[net]["v2v_net"], sub(net, "v2v_net"), f"{net}.v2v_net."
            ))
    return sd
