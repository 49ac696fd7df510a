"""JAX instance-segmentation head (Panoptic-DeepLab-style).

Replaces the reference's asynchronous TensorFlow Mask R-CNN bridge
(expected `MaskRCNN/` + C++ glue — SURVEY.md §3 "Instance segmentation
net", §4.5).  Mask R-CNN's proposal/NMS pipeline is dynamic-shaped and
hostile to XLA; the design here is a dense-prediction network whose
entire forward + instance grouping is static-shaped:

- ConvNet encoder/decoder (strided convs + GroupNorm + GELU, skip
  connections) -> per-pixel **semantic logits**, an instance **center
  heatmap**, and **center offsets** (Panoptic-DeepLab decomposition).
- Instance extraction: max-pool NMS on the heatmap, `top_k` centers
  (static K), every foreground pixel votes for its nearest predicted
  center — one (HW, K) distance argmin, no loops, no dynamic shapes.
- Class per instance by a one-hot matmul histogram.

The network is plain `lax` over a params pytree (`head_apply`); the
engine also accepts externally produced masks (e.g. ground truth or an
offline model) through the same `Segmentation` record, which is what the
synthetic end-to-end tests use.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Segmentation(NamedTuple):
    """Per-frame instance segmentation in network/table-agnostic form."""

    mask_id: jnp.ndarray  # i32[H,W] — per-pixel instance index in [0,K), -1 = none
    classes: jnp.ndarray  # i32[K] — semantic class per instance (0 = background)
    scores: jnp.ndarray  # f32[K] — center confidence
    valid: jnp.ndarray  # bool[K] — instance slot populated


# Parameter tree of the head, keyed exactly as the packaged checkpoint
# (`load_pretrained`): eight 3x3 conv blocks -- encoder e1..e4, middle, and
# decoder d3, d2, d1 -- then three 1x1 prediction convs (semantic, center,
# offset).
_BLOCK_SCALE = (1, 2, 4, 8, 8, 4, 2, 1)  # output channels / width
_GN_EPS = 1e-6


def _conv(p, x, stride: int = 1):
    """NHWC 'SAME' convolution with bias; f32 inputs may run in TF32 on
    GPUs (the head's tolerance is its segmentation quality, not digits)."""
    y = jax.lax.conv_general_dilated(
        x, p["kernel"], (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + p["bias"]


def _group_norm(p, x, groups: int):
    """GroupNorm over (H, W, C/groups) per example, then scale + bias."""
    n, h, w, c = x.shape
    g = x.reshape(n, h, w, groups, c // groups)
    mean = jnp.mean(g, axis=(1, 2, 4), keepdims=True)
    var = jnp.maximum(
        jnp.mean(g * g, axis=(1, 2, 4), keepdims=True) - mean * mean, 0.0
    )
    g = (g - mean) * jax.lax.rsqrt(var + _GN_EPS)
    return g.reshape(n, h, w, c) * p["scale"] + p["bias"]


def _conv_block(p, x, stride: int = 1):
    x = _conv(p["Conv_0"], x, stride)
    ch = x.shape[-1]
    return jax.nn.gelu(_group_norm(p["GroupNorm_0"], x, min(8, ch)))


def head_apply(params, rgb):
    """Panoptic head forward: rgb f32[H,W,3] in [0,1] (or [B,H,W,3]) ->
    (semantic logits [..,C], center heatmap [..], offsets [..,2]).

    Encoder/decoder of strided 3x3 convs + GroupNorm + GELU with skip
    connections; channels are deliberately modest (the reference runs
    Mask R-CNN every k frames on a desktop GPU; this head is sized to run
    per-keyframe on one device alongside tracking/fusion).
    """
    p = params["params"]
    batched = rgb.ndim == 4
    x = rgb if batched else rgb[None]
    blk = [p[f"_ConvBlock_{i}"] for i in range(8)]
    e1 = _conv_block(blk[0], x)  # H
    e2 = _conv_block(blk[1], e1, 2)  # H/2
    e3 = _conv_block(blk[2], e2, 2)  # H/4
    e4 = _conv_block(blk[3], e3, 2)  # H/8
    m = _conv_block(blk[4], e4)

    def up(x, skip, bp):
        x = jax.image.resize(
            x, (x.shape[0], skip.shape[1], skip.shape[2], x.shape[3]), "bilinear"
        )
        return _conv_block(bp, jnp.concatenate([x, skip], axis=-1))

    d3 = up(m, e3, blk[5])
    d2 = up(d3, e2, blk[6])
    d1 = up(d2, e1, blk[7])

    sem = _conv(p["Conv_0"], d1)
    center = _conv(p["Conv_1"], d1)[..., 0]
    offset = _conv(p["Conv_2"], d1)
    if not batched:
        sem, center, offset = sem[0], center[0], offset[0]
    return sem, center, offset


def extract_instances(
    sem_logits: jnp.ndarray,  # f32[H,W,C]
    center_heat: jnp.ndarray,  # f32[H,W] (pre-sigmoid)
    offsets: jnp.ndarray,  # f32[H,W,2] (dy, dx) to the instance center,
    #   in units of IMAGE WIDTH (resolution-normalized — see
    #   targets_from_instances; an FCN's features are local, so pixel-unit
    #   offsets cannot be consistent across input resolutions)
    max_instances: int,
    center_thresh: float = 0.0,
    nms_window: int = 7,
    max_assign_dist: float = 0.45,
) -> Segmentation:
    """Static-shaped grouping of dense predictions into K instance masks.

    All steps are XLA-friendly: max-pool NMS, `top_k`, one (HW, K) argmin,
    one-hot histogram matmul.  Pixels whose semantic argmax is background
    (class 0) get mask_id -1.
    """
    h, w = center_heat.shape
    k = max_instances

    # 1. Center NMS: a peak is a pixel equal to its neighborhood max.
    pooled = jax.lax.reduce_window(
        center_heat,
        -jnp.inf,
        jax.lax.max,
        (nms_window, nms_window),
        (1, 1),
        "SAME",
    )
    is_peak = (center_heat >= pooled) & (center_heat > center_thresh)
    peak_score = jnp.where(is_peak, center_heat, -jnp.inf).reshape(-1)
    scores, peak_idx = jax.lax.top_k(peak_score, k)
    valid = jnp.isfinite(scores)
    cy = (peak_idx // w).astype(jnp.float32)
    cx = (peak_idx % w).astype(jnp.float32)

    # 2. Pixel -> center voting: each pixel's predicted center position.
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    py = (yy + offsets[..., 0] * w).reshape(-1)  # (HW,)
    px = (xx + offsets[..., 1] * w).reshape(-1)
    d2 = (py[:, None] - cy[None, :]) ** 2 + (px[:, None] - cx[None, :]) ** 2
    d2 = jnp.where(valid[None, :], d2, jnp.inf)
    assign = jnp.argmin(d2, axis=-1).astype(jnp.int32)  # (HW,)
    # Distance gate: a pixel whose PREDICTED center is far from every
    # detected peak belongs to an object whose peak was missed this frame
    # (below threshold / NMS-suppressed).  Vanilla Panoptic-DeepLab still
    # assigns it to the nearest other instance — harmless for 2D panoptic
    # metrics, but poisonous here: those pixels cast persistent 3D label
    # VOTES for the wrong object/class.  Dropping them (mask -1) makes a
    # missed detection contribute nothing instead of wrong votes.  The
    # radius is loose (0.45 w): regression-to-the-mean offsets on LARGE
    # objects put rim pixels tens of px from the peak, and a tight gate
    # silenced whole objects; the class-consistency gate below is the
    # precise wrong-vote filter.
    near_ok = jnp.min(d2, axis=-1) <= (max_assign_dist * w) ** 2
    any_valid = jnp.any(valid)

    sem_cls = jnp.argmax(sem_logits, axis=-1).astype(jnp.int32)  # (H,W)
    fg = (sem_cls > 0).reshape(-1) & any_valid & near_ok
    mask_id = jnp.where(fg, assign, -1).reshape(h, w)

    # 3. Class per instance: histogram of semantic classes over each mask
    # as a one-hot matmul (integer counts: exact at any matmul precision).
    c = sem_logits.shape[-1]
    onehot_inst = jax.nn.one_hot(
        jnp.where(fg, assign, k), k + 1, dtype=jnp.float32
    )  # (HW, K+1)
    onehot_cls = jax.nn.one_hot(sem_cls.reshape(-1), c, dtype=jnp.float32)
    hist = jnp.einsum(
        "pk,pc->kc", onehot_inst[:, :k], onehot_cls
    )  # (K, C) pixel counts
    classes = jnp.argmax(hist[:, 1:], axis=-1).astype(jnp.int32) + 1
    pixels = jnp.sum(hist[:, 1:], axis=-1)
    valid = valid & (pixels > 0)
    classes = jnp.where(valid, classes, 0)
    # Class-consistency gate: drop pixels whose own semantic argmax
    # disagrees with their assigned instance's majority class — the pixel
    # grabbed a neighboring object's center (its own peak missed or its
    # offset wild).  This is the precise filter against wrong-CLASS 3D
    # votes; same-class fragment merges pass through untouched (the IoU
    # association downstream handles those).
    cls_px = classes[assign]
    keep = fg & (cls_px == sem_cls.reshape(-1))
    mask_id = jnp.where(keep, assign, -1).reshape(h, w)
    return Segmentation(
        mask_id=mask_id,
        classes=classes,
        scores=jnp.where(valid, scores, 0.0),
        valid=valid,
    )


def segment(
    params, rgb: jnp.ndarray, num_classes: int, max_instances: int,
    width: int = 32, center_thresh: float = -2.0,
) -> Segmentation:
    """Full forward + grouping for one frame (jit-able).

    `center_thresh` is on the pre-sigmoid heatmap (default -2.0 ≈ p=0.12):
    under-thresholding splits an object occasionally (fragments still
    carry the right class via the histogram, and the downstream IoU
    association can merge them), while over-thresholding MERGES distinct
    objects — the unrecoverable failure mode.
    """
    del num_classes, width  # implied by the params' shapes
    sem, center, offset = head_apply(params, rgb)
    return extract_instances(
        sem, center, offset, max_instances, center_thresh=center_thresh
    )


def init_params(rng, height: int, width_px: int, num_classes: int, width: int = 32):
    """Random head params: LeCun-normal kernels, zero biases, unit norms.

    `height`/`width_px` are accepted for call-site compatibility; the
    convolutional head's params do not depend on the image size.
    """
    del height, width_px
    keys = iter(jax.random.split(rng, 11))
    init = jax.nn.initializers.lecun_normal()

    def conv(ksize, cin, cout):
        return {
            "bias": jnp.zeros((cout,), jnp.float32),
            "kernel": init(next(keys), (ksize, ksize, cin, cout), jnp.float32),
        }

    chans = [width * s for s in _BLOCK_SCALE]
    cins = [3, chans[0], chans[1], chans[2], chans[3],
            chans[4] + chans[2], chans[5] + chans[1], chans[6] + chans[0]]
    p = {}
    for i, (cin, cout) in enumerate(zip(cins, chans)):
        p[f"_ConvBlock_{i}"] = {
            "Conv_0": conv(3, cin, cout),
            "GroupNorm_0": {
                "bias": jnp.zeros((cout,), jnp.float32),
                "scale": jnp.ones((cout,), jnp.float32),
            },
        }
    for i, cout in enumerate((num_classes, 1, 2)):
        p[f"Conv_{i}"] = conv(1, width, cout)
    return {"params": p}


# Packaged pretrained checkpoint (trained in-repo by _train_seghead.py on
# the synthetic scene; see tests/test_instances.py e2e).  num_classes=5,
# width=16.  The reference ships no weights either — it downloads a COCO
# Mask R-CNN; this is the self-contained equivalent for the synthetic rig.
PRETRAINED_SYNTHETIC = {
    "file": "weights/seghead_synthetic_w16.npz",
    "num_classes": 5,
    "width": 16,
}


def save_pretrained(path: str, params) -> None:
    """Flatten a head params pytree into a float16-packed npz."""
    import numpy as np

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    arrays = {
        jax.tree_util.keystr(kp): np.asarray(leaf, np.float16)
        for kp, leaf in flat
    }
    np.savez_compressed(path, **arrays)


def load_pretrained(path: str | None = None):
    """Load a checkpoint saved by `save_pretrained`.

    Returns (params, num_classes, width).  `path=None` loads the packaged
    synthetic-scene checkpoint.
    """
    import os

    import numpy as np

    meta = PRETRAINED_SYNTHETIC
    if path is None:
        path = os.path.join(os.path.dirname(__file__), meta["file"])
    data = np.load(path)
    # Rebuild the pytree structure from an init skeleton keyed the same way.
    params = init_params(
        jax.random.PRNGKey(0), 8, 8, meta["num_classes"], meta["width"]
    )
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = [
        jnp.asarray(data[jax.tree_util.keystr(kp)], jnp.float32)
        for kp, _ in flat
    ]
    return (
        jax.tree_util.tree_unflatten(treedef, leaves),
        meta["num_classes"],
        meta["width"],
    )


# --------------------------------------------------------------------------
# Training (the reference consumes a pretrained Mask R-CNN; this head is
# trainable in-framework so the segmentation component is self-contained)
# --------------------------------------------------------------------------


def targets_from_instances(
    instance_img: jnp.ndarray,  # i32[H,W] ground-truth instance ids, -1 none
    class_of_instance: jnp.ndarray,  # i32[K] semantic class per id (0 = bg)
    sigma: float = 4.0,
):
    """Panoptic-DeepLab training targets from instance-id ground truth.

    Returns (sem i32[H,W], center f32[H,W], offset f32[H,W,2]): semantic
    class per pixel, a Gaussian bump at each instance's centroid, and the
    per-pixel vector to its instance centroid in units of IMAGE WIDTH.
    The normalization makes the offset channel resolution-independent:
    the same physical scene rendered at 160x120 and 320x240 needs the
    same normalized offsets, so one FCN checkpoint serves both (pixel
    units forced the r5 multi-resolution training into an unresolvable
    conflict — the offset branch never converged and masks fragmented).
    """
    h, w = instance_img.shape
    k = class_of_instance.shape[0]
    ids = jnp.clip(instance_img, 0, k - 1)
    valid = instance_img >= 0
    sem = jnp.where(valid, class_of_instance[ids], 0)

    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    onehot = jax.nn.one_hot(jnp.where(valid, instance_img, k), k + 1)[..., :k]
    count = jnp.sum(onehot, axis=(0, 1))  # (K,)
    cy = jnp.sum(onehot * yy[..., None], axis=(0, 1)) / jnp.maximum(count, 1.0)
    cx = jnp.sum(onehot * xx[..., None], axis=(0, 1)) / jnp.maximum(count, 1.0)

    d2 = (yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2  # (H,W,K)
    bump = jnp.exp(-d2 / (2.0 * sigma * sigma))
    bump = jnp.where(count[None, None, :] > 0, bump, 0.0)
    center = jnp.max(bump, axis=-1)

    off_y = (jnp.sum(onehot * cy, axis=-1) - yy) / w
    off_x = (jnp.sum(onehot * cx, axis=-1) - xx) / w
    offset = jnp.where(
        valid[..., None], jnp.stack([off_y, off_x], axis=-1), 0.0
    )
    return sem, center, offset


def loss_fn(params, rgb, sem_t, center_t, offset_t, num_classes: int,
            width: int = 32, center_weight: float = 10.0,
            offset_weight: float = 30.0):
    """Combined loss: semantic CE + center MSE + masked offset L1."""
    del num_classes, width  # implied by the params' shapes
    sem, center, offset = head_apply(params, rgb)
    ce = -jnp.mean(
        jnp.take_along_axis(
            jax.nn.log_softmax(sem, axis=-1), sem_t[..., None], axis=-1
        )
    )
    cm = jnp.mean((jax.nn.sigmoid(center) - center_t) ** 2)
    fg = (sem_t > 0).astype(jnp.float32)[..., None]
    ol = jnp.sum(jnp.abs(offset - offset_t) * fg) / jnp.maximum(jnp.sum(fg), 1.0)
    total = ce + center_weight * cm + offset_weight * ol
    return total, {"ce": ce, "center": cm, "offset": ol}


def train_step(params, opt_state, rgb, targets, tx, num_classes: int,
               width: int = 32):
    """One optax update on a single frame (or vmapped batch upstream)."""
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, rgb, *targets, num_classes=num_classes, width=width
    )
    updates, opt_state = tx.update(grads, opt_state, params)
    import optax

    params = optax.apply_updates(params, updates)
    return params, opt_state, loss, aux
