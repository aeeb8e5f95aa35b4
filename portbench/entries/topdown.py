"""Top-down entry: SelfPose3d's pseudo-label stage s4 on a batch of frame sets.

One call hands the program's ``pseudo_labels/inference.py:topdown_keypoints``
the batch's HD frames (uint8 RGB) and pseudo-boxes from pinned memory, as
its ``topdown_calls`` groups and pads them for the s4 command line; the
program copies them to the device, crops every box there, runs its HRNet
with the flip test, decodes, and copies the keypoints to the host, which
waits for the device.

The inputs, from the seed (traffic ``s4_*``): noise frames of
``frame_wh`` drawn on the device in one call, ``boxes_per_view`` boxes a
view with heights in ``box_height`` px and widths of ``box_aspect`` of the
height, inside the frame. The check, per kept call (the worst call counts):

  crop_rel      ||crops - crops_ref|| / ||crops_ref|| of the normalized
                crops, the reference's own crops of the same boxes.
  heatmap_rel   the same of the flip-averaged heatmaps, the reference's
                computed from its own crops (the logits: at random weights
                an argmax flips on rounding, so keypoints are not compared
                across the networks).
  keypoint_gap  the largest distance in image pixels between the program's
                keypoints and the reference's decode of the program's own
                heatmaps; infinite where a score differs from the
                reference's maximum by more than 1e-5 of the largest.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.core import compare, feed, flops_hrnet, scene
from portbench.reference.hrnet import HRNetReference, param_spec

# ``scene.seeded_weights`` lifts this multi-view model's bias: one entry of
# the draw, dropped before the weights load
_ROOT_BIAS = "root_net.v2v_net.output_layer.bias"


def seeded_weights(extra: dict, joints: int, seed: int, device):
    spec = dict(param_spec(extra, joints))
    spec[_ROOT_BIAS] = ((1,), "bias")
    P = scene.seeded_weights(spec, seed, device)
    del P[_ROOT_BIAS]
    return P


def make_pool(traffic: dict, seed: int, device):
    """``traffic["pool"]`` calls of s4's batched path, each grouped and padded
    by the program's ``topdown_calls`` as the s4 command line's are: (frames
    (F, H, W, 3) uint8, boxes (n, 4) xywh float32, frame_of (n,) int64, the
    keys of the real boxes), host tensors, pinned."""
    from selfpose3d_tpu_torch.pseudo_labels.inference import IMAGES_PER_CALL, topdown_calls

    W, H = traffic["frame_wh"]
    F = traffic["batch"] * traffic["views"]
    per = traffic["boxes_per_view"]
    n = traffic["pool"]
    g = torch.Generator(device=device).manual_seed(scene.sub_seed(seed, 1 << 20))
    frames = torch.randint(0, 256, (n, F, H, W, 3), generator=g, device=device,
                           dtype=torch.uint8).cpu()
    pool = []
    for i in range(n):
        rs = np.random.RandomState(scene.sub_seed(seed, i, 2))
        h = rs.uniform(*traffic["box_height"], F * per)
        w = h * rs.uniform(*traffic["box_aspect"], F * per)
        x = rs.uniform(0.0, 1.0, F * per) * (W - w)
        y = rs.uniform(0.0, 1.0, F * per) * (H - h)
        boxes = np.stack([x, y, w, h], 1).astype(np.float32)
        calls = list(topdown_calls((frames[i, f], boxes[f * per:(f + 1) * per],
                                    range(f * per, (f + 1) * per)) for f in range(F)))
        if len(calls) != 1:
            raise ValueError(f"a call of s4 takes {IMAGES_PER_CALL} images, not {F}")
        pool.append(calls[0])
    return pool


def keypoint_gap(kp: torch.Tensor, kp_ref: torch.Tensor) -> float:
    kp, kp_ref = kp.double().cpu(), kp_ref.double().cpu()
    scores = (kp[..., 2] - kp_ref[..., 2]).abs().amax()
    if not bool(torch.isfinite(kp).all()) or float(scores) > 1e-5 * float(kp_ref[..., 2].abs().amax()):
        return math.inf
    return float((kp[..., :2] - kp_ref[..., :2]).norm(dim=-1).amax())


class Program:
    def __init__(self, ctx):
        from selfpose3d_tpu_torch.models import get_model

        self.ctx, c, dev = ctx, ctx.prog_cfg, ctx.device
        self.extra, self.joints = dict(c.MODEL_EXTRA), c.NETWORK.NUM_JOINTS
        self.input_wh = tuple(c.NETWORK.IMAGE_SIZE)
        self.flags = {"flip": c.TEST.FLIP_TEST, "shift": c.TEST.SHIFT_HEATMAP,
                      "post": c.TEST.POST_PROCESS}
        self.crops = ctx.traffic["batch"] * ctx.traffic["views"] * ctx.traffic["boxes_per_view"]
        self.P = seeded_weights(self.extra, self.joints, ctx.seed, dev)
        self.model = get_model(c, device=dev)
        self.model.load_state_dict(self.P)
        self.pool = make_pool(ctx.traffic, ctx.seed, dev)
        for i in range(ctx.traffic.get("warmup_calls", 2)):
            self.call(i)

    def call(self, i: int):
        from selfpose3d_tpu_torch.pseudo_labels.inference import topdown_keypoints

        frames, boxes, frame_of, keys = self.pool[i % len(self.pool)]
        kp, crops, hm = topdown_keypoints(self.model, frames, boxes, frame_of, keep=True,
                                          **self.flags)
        n = len(keys)  # the padding's keypoints are dropped, as the s4 command line drops them
        return i, kp[:n], crops[:n], hm[:n]

    @property
    def items_per_call(self) -> int:
        return self.ctx.traffic["batch"]

    def flops_per_call(self) -> int:
        w, h = self.input_wh
        return flops_hrnet.topdown_flops(self.extra, self.joints, (h, w), self.crops,
                                         self.flags["flip"])

    def sampler_bytes_per_call(self) -> int:
        return 0

    def release(self) -> None:
        del self.model

    def _reference(self, fp8: bool = False) -> HRNetReference:
        return HRNetReference(self.P, self.extra, self.input_wh, fp8=fp8)

    def _inputs(self, i: int):
        frames, boxes, frame_of, keys = self.pool[i % len(self.pool)]
        dev, n = self.ctx.device, len(keys)
        return frames.to(dev), boxes[:n].to(dev), frame_of[:n].to(dev)

    def check(self, kept):
        """The worst of the kept calls' numbers against the float32 reference."""
        ref = self._reference()
        rows = []
        with torch.no_grad():
            for i, kp, crops, hm in kept:
                frames, boxes, frame_of = self._inputs(i)
                crops_ref = ref.crops(frames, boxes, frame_of)
                del frames
                row = {"crop_rel": compare.rel_l2(crops.permute(0, 3, 1, 2), crops_ref)}
                hm_ref = ref.heatmaps(crops_ref, self.flags["flip"], self.flags["shift"])
                del crops_ref
                hm_nchw = hm.permute(0, 3, 1, 2)
                row["heatmap_rel"] = compare.rel_l2(hm_nchw, hm_ref)
                del hm_ref
                kp_ref = ref.keypoints(hm_nchw, boxes, self.flags["post"])
                row["keypoint_gap"] = keypoint_gap(kp, kp_ref)
                rows.append(row)
        return compare.worst(rows)

    def control(self, i: int, fp8: bool = True):
        """The reference put in the program's place (``fp8``) on call ``i``'s
        inputs: (i, keypoints, crops (N, h, w, 3), heatmaps (N, H, W, J)) as
        ``call`` returns them."""
        ref = self._reference(fp8)
        with torch.no_grad():
            frames, boxes, frame_of = self._inputs(i)
            crops = ref.crops(frames, boxes, frame_of)
            hm = ref.heatmaps(crops, self.flags["flip"], self.flags["shift"])
            kp = ref.keypoints(hm, boxes, self.flags["post"]).float().cpu()
        return i, kp, crops.permute(0, 2, 3, 1), hm.permute(0, 2, 3, 1)
