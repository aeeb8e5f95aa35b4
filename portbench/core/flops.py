"""Operations and bytes of a call, from the configuration's shapes.

FLOPs count the multiply-adds of every convolution and transposed
convolution as 2 each (bias and normalisation left out), as
``torch.utils.flop_counter`` counts them. A backward counts the weight
gradient of every trained layer and the input gradient of every layer
whose input needs one, each as much as the layer's forward; nothing is
counted for recomputation, which the program does not do.

Sampler bytes count each input byte read once and each output byte
written once: the heatmaps, the coordinates (px, py and, for the view
mean, the in-image mask), the samples, in float32 (the view mean's
output in the compute dtype).
"""

from __future__ import annotations

from math import prod

from portbench.reference.model import RESNETS


def _conv(cin, cout, k, out_spatial):
    return 2 * cin * cout * prod(k) * prod(out_spatial)


def resnet_flops(layers, H, W, joints, deconv_filters=(256, 256, 256), final_k=1):
    """(all, first layer) FLOPs of one image through the ResNet and its head."""
    kind, counts = RESNETS[layers]
    h, w = (H + 1) // 2, (W + 1) // 2
    first = _conv(3, 64, (7, 7), (h, w))
    total = first
    h, w = (h + 1) // 2, (w + 1) // 2  # max-pool
    cin = 64
    for si, (planes, n) in enumerate(zip((64, 128, 256, 512), counts)):
        for bi in range(n):
            stride = (1 if si == 0 else 2) if bi == 0 else 1
            ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
            if kind == "bottleneck":
                cout = planes * 4
                total += _conv(cin, planes, (1, 1), (h, w))
                total += _conv(planes, planes, (3, 3), (ho, wo))
                total += _conv(planes, cout, (1, 1), (ho, wo))
            else:
                cout = planes
                total += _conv(cin, planes, (3, 3), (ho, wo))
                total += _conv(planes, planes, (3, 3), (ho, wo))
            if stride != 1 or cin != cout:
                total += _conv(cin, cout, (1, 1), (ho, wo))
            h, w, cin = ho, wo, cout
    for f in deconv_filters:  # transposed: counted over the input positions
        total += _conv(cin, f, (4, 4), (h, w))
        h, w, cin = 2 * h, 2 * w, f
    total += _conv(cin, joints, (final_k, final_k), (h, w))
    return total, first


def v2v_flops(cin, cout, X, Y, Z):
    """(all, first layer) FLOPs of one cube through the V2V network."""
    full, half, quarter = (X, Y, Z), (X // 2, Y // 2, Z // 2), (X // 4, Y // 4, Z // 4)
    k3 = (3, 3, 3)

    def res(a, b, s):
        return _conv(a, b, k3, s) + _conv(b, b, k3, s) + (_conv(a, b, (1, 1, 1), s) if a != b else 0)

    first = _conv(cin, 16, (7, 7, 7), full)
    total = first + res(16, 32, full) + res(32, 32, full)
    total += res(32, 64, half) + res(64, 64, half)
    total += res(64, 128, quarter) + res(128, 128, quarter) + res(128, 128, quarter)
    total += _conv(128, 64, (2, 2, 2), quarter) + res(64, 64, half)
    total += _conv(64, 32, (2, 2, 2), half)
    total += _conv(32, cout, (1, 1, 1), full)
    return total, first


def infer_flops(cfg, batch: int) -> int:
    """One inference call: the backbone on every view, RootNet's V2V on
    every frame set, PoseNet's V2V on every candidate slot."""
    W, H = cfg.image_wh
    bb, _ = resnet_flops(cfg.layers, H, W, cfg.joints, cfg.deconv_filters, cfg.final_k)
    root, _ = v2v_flops(cfg.root_in, 1, *cfg.root_cube)
    pose, _ = v2v_flops(cfg.joints, cfg.joints, *cfg.pose_cube)
    return batch * (cfg.views * bb + root + cfg.max_people * pose)


def ssv_train_flops(cfg, batch: int) -> int:
    """One SSV train step with RootNet frozen: the backbone on the three
    branches' views, the attention net on two, RootNet on the third,
    PoseNet on two branches' candidates; the backward of the trained nets."""
    W, H = cfg.image_wh
    V, K = cfg.views, cfg.max_people
    bb, bb0 = resnet_flops(cfg.layers, H, W, cfg.joints, cfg.deconv_filters, cfg.final_k)
    at, at0 = resnet_flops(cfg.attn_layers, H, W, cfg.joints) if cfg.with_attn else (0, 0)
    root, _ = v2v_flops(cfg.root_in, 1, *cfg.root_cube)
    pose, pose0 = v2v_flops(cfg.joints, cfg.joints, *cfg.pose_cube)
    fwd = 3 * batch * V * bb + 2 * batch * V * at + batch * root + 2 * batch * K * pose
    bwd = 2 * batch * V * (2 * at - at0)
    if cfg.train_backbone:  # the cubes' gradient reaches the heatmaps
        bwd += 3 * batch * V * (2 * bb - bb0) + 2 * batch * K * 2 * pose
    else:
        bwd += 2 * batch * K * (2 * pose - pose0)
    return fwd + bwd


# ---- sampler bytes

def sample_view_bytes(b, h, w, j, n):
    """One ``sample_view``: heatmap (b, h, w, j), px and py (b, n), samples (b, n, j)."""
    return 4 * (b * h * w * j + 2 * b * n + b * n * j)


def adjoint_bytes(b, h, w, j, n):
    """One ``sample_view_adjoint``: cotangent (b, n, j), px and py, gradient (b, h, w, j)."""
    return 4 * (b * n * j + 2 * b * n + b * h * w * j)


def views_mean_bytes(b, v, h, w, j, n, out_bytes=2):
    """One ``sample_views_mean``: heatmaps (b, v, h, w, j), px, py and the
    mask (b, v, n), the mean (b, n, j) in the compute dtype."""
    return 4 * (b * v * h * w * j + 3 * b * v * n) + out_bytes * b * n * j


def infer_sampler_bytes(cfg, batch: int) -> int:
    W, H = cfg.heatmap_wh
    n_root = prod(cfg.root_cube)
    n_pose = cfg.max_people * prod(cfg.pose_cube)
    return (cfg.views * sample_view_bytes(batch, H, W, cfg.root_in, n_root)
            + views_mean_bytes(batch, cfg.views, H, W, cfg.joints, n_pose))


def ssv_train_sampler_bytes(cfg, batch: int) -> int:
    W, H = cfg.heatmap_wh
    V, J = cfg.views, cfg.joints
    n_root = prod(cfg.root_cube)
    n_pose = cfg.max_people * prod(cfg.pose_cube)
    total = V * sample_view_bytes(batch, H, W, cfg.root_in, n_root)
    total += V * sample_view_bytes(2 * batch, H, W, J, n_pose)
    if cfg.train_backbone:
        total += V * adjoint_bytes(2 * batch, H, W, J, n_pose)
    return total
