"""Plain PyTorch reference of SelfPose3d's pseudo-label stage s4: the HRNet
repository's top-down test (deep-high-resolution-net.pytorch: lib/models/
pose_hrnet.py, lib/core/function.py:validate, lib/core/inference.py,
lib/utils/transforms.py) on pseudo-boxes.

Written from the published code as functions over a flat dict of
parameters named as the published state dict names them: the crop of
each box (``_box2cs``: 1.25 context, pixel_std 200; the affine of
``get_affine_transform`` at rotation 0, sampled bilinearly with a zero
border by ``F.grid_sample`` and rounded to image levels, as
``cv2.warpAffine`` writes a uint8 crop; ToTensor and the ImageNet
normalisation), the network (NCHW, float32, eval BatchNorm), the flip test
(FLIP_TEST, SHIFT_HEATMAP) and the decode (``get_final_preds`` with
POST_PROCESS, ``transform_preds``). TF32 off; crops run in blocks, so
that a large batch fits. It imports nothing of the program under test.

``fp8=True`` is the control that has to fail the comparison: every step
in float8 e4m3 (one scale a tensor) where the program computes in
bfloat16 or float32: the crops, every convolution's input, weight and
output, every BatchNorm's output, and the decoded keypoints' coordinates.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.model import EPS, _bn, _conv, fp8_round, no_tf32

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))


def _stages(extra: dict):
    for s in (2, 3, 4):
        st = extra[f"STAGE{s}"]
        if st["BLOCK"] != "BASIC":
            raise ValueError("the reference computes HRNet's BASIC branches")
        yield s, st


def param_spec(extra: dict, joints: int) -> Dict[str, tuple]:
    """Every parameter and buffer of the published PoseHighResolutionNet,
    name -> (shape, kind); each residual branch's last BatchNorm ``bn_last``."""
    spec: Dict[str, tuple] = {}
    _conv(spec, "conv1", 3, 64, 3, 2, False)
    _bn(spec, "bn1", 64)
    _conv(spec, "conv2", 64, 64, 3, 2, False)
    _bn(spec, "bn2", 64)
    cin = 64
    for b in range(4):
        p = f"layer1.{b}."
        _conv(spec, p + "conv1", cin, 64, 1, 2, False)
        _bn(spec, p + "bn1", 64)
        _conv(spec, p + "conv2", 64, 64, 3, 2, False)
        _bn(spec, p + "bn2", 64)
        _conv(spec, p + "conv3", 64, 256, 1, 2, False)
        _bn(spec, p + "bn3", 256, last=True)
        if b == 0:
            _conv(spec, p + "downsample.0", cin, 256, 1, 2, False)
            _bn(spec, p + "downsample.1", 256)
        cin = 256
    pre = [256]
    for s, st in _stages(extra):
        c = list(st["NUM_CHANNELS"])
        t = f"transition{s - 1}."
        for i, ci in enumerate(c):
            if i < len(pre):
                if ci != pre[i]:
                    _conv(spec, f"{t}{i}.0", pre[i], ci, 3, 2, False)
                    _bn(spec, f"{t}{i}.1", ci)
            else:
                n = i + 1 - len(pre)
                for k in range(n):
                    cout = ci if k == n - 1 else pre[-1]
                    _conv(spec, f"{t}{i}.{k}.0", pre[-1], cout, 3, 2, False)
                    _bn(spec, f"{t}{i}.{k}.1", cout)
        for m in range(st["NUM_MODULES"]):
            p = f"stage{s}.{m}."
            for b, (cb, nb) in enumerate(zip(c, st["NUM_BLOCKS"])):
                for k in range(nb):
                    q = f"{p}branches.{b}.{k}."
                    _conv(spec, q + "conv1", cb, cb, 3, 2, False)
                    _bn(spec, q + "bn1", cb)
                    _conv(spec, q + "conv2", cb, cb, 3, 2, False)
                    _bn(spec, q + "bn2", cb, last=True)
            outs = 1 if (s == 4 and m == st["NUM_MODULES"] - 1) else len(c)
            for i in range(outs if len(c) > 1 else 0):
                for j in range(len(c)):
                    q = f"{p}fuse_layers.{i}.{j}."
                    if j > i:
                        _conv(spec, q + "0", c[j], c[i], 1, 2, False)
                        _bn(spec, q + "1", c[i])
                    elif j < i:
                        for k in range(i - j):
                            cout = c[i] if k == i - j - 1 else c[j]
                            _conv(spec, f"{q}{k}.0", c[j], cout, 3, 2, False)
                            _bn(spec, f"{q}{k}.1", cout)
        pre = c
    _conv(spec, "final_layer", pre[0], joints, int(extra.get("FINAL_CONV_KERNEL", 1)), 2, True)
    return spec


class HRNetReference:
    """s4's functions over the parameters ``P`` (name -> tensor)."""

    def __init__(self, P: Dict[str, torch.Tensor], extra: dict, input_wh=(288, 384),
                 fp8: bool = False):
        self.P, self.extra, self.fp8 = P, extra, fp8
        self.input_wh = tuple(input_wh)
        no_tf32()

    def _r(self, x):
        return fp8_round(x) if self.fp8 else x

    # ---- the crops
    @staticmethod
    def box2cs(boxes: torch.Tensor, aspect: float):
        """_box2cs of (N, 4) xywh boxes, float64 -> center (N, 2), scale (N, 2)."""
        b = boxes.double()
        x, y, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
        center = torch.stack([x + w * 0.5, y + h * 0.5], 1)
        w2 = torch.where(w > aspect * h, w, h * aspect)
        h2 = torch.where(w > aspect * h, w / aspect, h)
        return center, torch.stack([w2 / 200.0, h2 / 200.0], 1) * 1.25

    def crops(self, frames: torch.Tensor, boxes: torch.Tensor, frame_of: torch.Tensor,
              block: int = 16) -> torch.Tensor:
        """uint8 (F, H, W, 3) RGB frames, (N, 4) boxes, (N,) frames -> (N, 3,
        h, w) normalized crops. Output pixel (u, v) samples at (u - w/2) *
        s + cx, (v - h/2) * s + cy, s = scale_w * 200 / w (the inverse of
        ``get_affine_transform``'s map at rotation 0)."""
        w, h = self.input_wh
        _, H, W, _ = frames.shape
        center, scale = self.box2cs(boxes, w / h)
        s = scale[:, 0] * 200.0 / w
        u = torch.arange(w, dtype=torch.float64, device=frames.device) - w / 2
        v = torch.arange(h, dtype=torch.float64, device=frames.device) - h / 2
        mean = torch.tensor(MEAN, device=frames.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=frames.device).view(1, 3, 1, 1)
        out = []
        for a in range(0, boxes.shape[0], block):
            n = slice(a, a + block)
            sx = center[n, :1] + u * s[n, None]  # (b, w) image pixels
            sy = center[n, 1:] + v * s[n, None]  # (b, h)
            gx = (2.0 * sx + 1.0) / W - 1.0  # align_corners=False: pixel centres
            gy = (2.0 * sy + 1.0) / H - 1.0
            b = gx.shape[0]
            grid = torch.stack([gx[:, None, :].expand(b, h, w), gy[:, :, None].expand(b, h, w)], -1)
            src = frames[frame_of[n].long()].permute(0, 3, 1, 2).float()
            lv = F.grid_sample(src, grid.float(), mode="bilinear", padding_mode="zeros",
                               align_corners=False)
            lv = torch.round(lv).clamp(0, 255)
            out.append(self._r((lv / 255.0 - mean) / std))
        return torch.cat(out)

    # ---- the network (NCHW)
    def conv(self, x, name, stride=1, pad=0):
        w, b = self.P[name + ".weight"], self.P.get(name + ".bias")
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return self._r(F.conv2d(x, w, b, stride, pad))

    def bn(self, x, name):
        P = self.P
        g = lambda k: P[f"{name}.{k}"].view(1, -1, 1, 1)  # noqa: E731
        return self._r((x - g("running_mean")) * torch.rsqrt(g("running_var") + EPS) * g("weight")
                       + g("bias"))

    def cbr(self, x, name, stride, relu=True):
        """conv (3x3 where the kernel is 3, else 1x1) -> BN (-> ReLU) of a Sequential ``name``."""
        k = self.P[name + ".0.weight"].shape[-1]
        y = self.bn(self.conv(x, name + ".0", stride, k // 2), name + ".1")
        return F.relu(y) if relu else y

    def basic(self, x, p):
        y = F.relu(self.bn(self.conv(x, p + "conv1", 1, 1), p + "bn1"))
        y = self.bn(self.conv(y, p + "conv2", 1, 1), p + "bn2")
        return F.relu(y + x)

    def bottleneck(self, x, p, down):
        y = F.relu(self.bn(self.conv(x, p + "conv1"), p + "bn1"))
        y = F.relu(self.bn(self.conv(y, p + "conv2", 1, 1), p + "bn2"))
        y = self.bn(self.conv(y, p + "conv3"), p + "bn3")
        r = self.bn(self.conv(x, p + "downsample.0"), p + "downsample.1") if down else x
        return F.relu(y + r)

    def network(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, h, w) -> (B, J, h/4, w/4)."""
        x = F.relu(self.bn(self.conv(x, "conv1", 2, 1), "bn1"))
        x = F.relu(self.bn(self.conv(x, "conv2", 2, 1), "bn2"))
        for b in range(4):
            x = self.bottleneck(x, f"layer1.{b}.", b == 0)
        ys: List[torch.Tensor] = [x]
        for s, st in _stages(self.extra):
            t = f"transition{s - 1}."
            xs = []
            for i in range(len(st["NUM_CHANNELS"])):
                if f"{t}{i}.0.weight" in self.P:  # a kept branch that changes width
                    xs.append(self.cbr(ys[i], f"{t}{i}", 1))
                elif i < len(ys):
                    xs.append(ys[i])
                else:
                    y, k = ys[-1], 0
                    while f"{t}{i}.{k}.0.weight" in self.P:
                        y = self.cbr(y, f"{t}{i}.{k}", 2)
                        k += 1
                    xs.append(y)
            for m in range(st["NUM_MODULES"]):
                p = f"stage{s}.{m}."
                for b, nb in enumerate(st["NUM_BLOCKS"]):
                    for k in range(nb):
                        xs[b] = self.basic(xs[b], f"{p}branches.{b}.{k}.")
                nbr = len(xs)
                outs = 1 if (s == 4 and m == st["NUM_MODULES"] - 1) else nbr
                if nbr == 1:
                    continue
                fused = []
                for i in range(outs):
                    y = xs[i]
                    for j in range(nbr):
                        q = f"{p}fuse_layers.{i}.{j}"
                        if j > i:
                            z = self.bn(self.conv(xs[j], q + ".0"), q + ".1")
                            y = y + F.interpolate(z, scale_factor=2 ** (j - i), mode="nearest")
                        elif j < i:
                            z = xs[j]
                            for k in range(i - j):
                                z = self.cbr(z, f"{q}.{k}", 2, relu=k < i - j - 1)
                            y = y + z
                    fused.append(F.relu(y))
                xs = fused
            ys = xs
        k = self.P["final_layer.weight"].shape[-1]
        return self.conv(ys[0], "final_layer", 1, 1 if k == 3 else 0)

    def heatmaps(self, crops: torch.Tensor, flip: bool = True, shift: bool = True,
                 block: int = 16) -> torch.Tensor:
        """(N, 3, h, w) crops -> (N, J, h/4, w/4), with the published flip
        test (lib/core/function.py:validate)."""
        out = []
        for a in range(0, crops.shape[0], block):
            x = crops[a:a + block]
            hm = self.network(x)
            if flip:
                hf = self.network(torch.flip(x, [3]))
                hf = torch.flip(hf, [3])  # flip_back: mirror, then swap the pairs
                idx = list(range(hf.shape[1]))
                for l, r in FLIP_PAIRS:
                    idx[l], idx[r] = r, l
                hf = hf[:, idx]
                if shift:
                    hf[:, :, :, 1:] = hf.clone()[:, :, :, 0:-1]
                hm = (hm + hf) * 0.5
            out.append(hm)
        return torch.cat(out)

    # ---- the decode
    def keypoints(self, hm: torch.Tensor, boxes: torch.Tensor, post: bool = True) -> torch.Tensor:
        """get_final_preds: (N, J, H, W) heatmaps and their boxes -> (N, J, 3)
        image-pixel keypoints and maxima, float64."""
        N, J, H, W = hm.shape
        w, h = self.input_wh
        center, scale = self.box2cs(boxes, w / h)
        flat = hm.double().reshape(N, J, H * W)
        idx = torch.argmax(flat, 2)
        maxvals = torch.amax(flat, 2)
        coords = torch.stack([(idx % W).double(), torch.floor(idx.double() / W)], -1)
        coords = coords * (maxvals > 0.0).double()[..., None]
        if post:
            px = torch.floor(coords[..., 0] + 0.5).long()
            py = torch.floor(coords[..., 1] + 0.5).long()
            ok = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
            pxc, pyc = px.clamp(1, W - 2), py.clamp(1, H - 2)
            at = lambda yy, xx: flat.gather(2, (yy * W + xx)[..., None])[..., 0]  # noqa: E731
            diff = torch.stack([at(pyc, pxc + 1) - at(pyc, pxc - 1),
                                at(pyc + 1, pxc) - at(pyc - 1, pxc)], -1)
            coords = coords + torch.where(ok[..., None], torch.sign(diff) * 0.25,
                                          torch.zeros_like(diff))
        s = (scale[:, 0] * 200.0 / W)[:, None, None]  # transform_preds, at the heatmap's size
        half = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float64, device=hm.device)
        xy = (coords - half) * s + center[:, None, :]
        if self.fp8:
            xy = fp8_round(xy)
        return torch.cat([xy, maxvals[..., None]], -1)
