"""Train the Panoptic-DeepLab head on RANDOMIZED synthetic scenes (dev tool).

Produces the in-repo pretrained checkpoint consumed by
`models.segmentation.load_pretrained` and the config-3 e2e path.

r5 (VERDICT r4 ask #9): the head now trains across multiple randomized
scenes (object count/kind/pose/size/color vary by seed —
`synthetic.random_scene`) at BOTH 320x240 and 160x120, with semantic
class = object KIND (1 sphere, 2 box, 3 cylinder).  The fixed legacy
scene is included so the packaged checkpoint keeps serving the existing
e2e tests; seed HELD_OUT (default 1234) is never trained on and gates
generalization in tests/test_instances.py.

    python _train_seghead.py                 # trains on the CPU, writes the npz
    STEPS=50 python _train_seghead.py        # quick smoke
    TRAIN_PLATFORM=gpu python _train_seghead.py    # train on the GPU

Output: instancefusion_tpu/models/weights/seghead_synthetic_w16.npz
(float16-packed head params, keyed as `models.segmentation.load_pretrained`
reads them, ~0.8 MB).
"""
import os

from instancefusion_tpu.utils.runtime import setup

_platform = os.environ.get("TRAIN_PLATFORM", "cpu")
setup(None if _platform == "gpu" else _platform)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from instancefusion_tpu.datasets import synthetic  # noqa: E402
from instancefusion_tpu.geometry.camera import Intrinsics  # noqa: E402
from instancefusion_tpu.models import segmentation as seg  # noqa: E402

INTR_160 = Intrinsics(fx=129.3, fy=129.1, cx=79.5, cy=59.5, width=160, height=120)
INTR_320 = Intrinsics(fx=258.6, fy=258.2, cx=159.5, cy=119.5, width=320, height=240)
NUM_CLASSES = 5  # bg + sphere/box/cylinder kinds (+1 spare)
WIDTH = 16
STEPS = int(os.environ.get("STEPS", "4000"))
TRAIN_SEEDS = tuple(range(1, 13))  # randomized scenes seen in training
HELD_OUT = int(os.environ.get("HELD_OUT", "1234"))  # NEVER trained on
OUT = os.path.join(
    os.path.dirname(__file__),
    "instancefusion_tpu", "models", "weights", "seghead_synthetic_w16.npz",
)


def _poses(n):
    return np.concatenate([
        np.asarray(synthetic.orbit_trajectory(n // 2, sweep=1.6)),
        np.asarray(synthetic.handheld_trajectory(n - n // 2, sweep=1.8)),
    ])


def make_dataset():
    """(frame, class_of_instance) pairs across scenes and resolutions."""
    assert HELD_OUT not in TRAIN_SEEDS
    data = []
    # Legacy fixed scene: ids 1..3 are already kind-numbered.
    fixed_cls = jnp.arange(NUM_CLASSES, dtype=jnp.int32)
    for i, p in enumerate(_poses(8)):
        intr = INTR_320 if i % 2 == 0 else INTR_160
        data.append((synthetic.render_frame(jnp.asarray(p), intr), fixed_cls))
    for seed in TRAIN_SEEDS:
        sc = synthetic.random_scene(seed)
        # class of instance id i+1 = kind of slot i; id 0 (walls) = bg.
        cls = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), sc.kinds.astype(jnp.int32)]
        )
        for i, p in enumerate(_poses(12)):
            intr = INTR_320 if i % 2 == 0 else INTR_160
            data.append(
                (synthetic.render_frame_scene(jnp.asarray(p), intr, sc), cls)
            )
    return data


def targets(frame, class_of):
    # Walls (instance id 0) are stuff/background; objects are things.
    inst = jnp.where(frame.instance == 0, -1, frame.instance)
    return seg.targets_from_instances(inst, class_of)


def main():
    data = make_dataset()
    tgts = [targets(f, c) for f, c in data]
    params = seg.init_params(
        jax.random.PRNGKey(0), INTR_320.height, INTR_320.width, NUM_CLASSES,
        WIDTH,
    )
    tx = optax.adam(
        optax.cosine_decay_schedule(1e-3, STEPS, alpha=0.05)
    )
    opt_state = tx.init(params)

    step = jax.jit(
        lambda p, o, rgb, t: seg.train_step(
            p, o, rgb, t, tx, NUM_CLASSES, WIDTH
        )
    )
    rng = np.random.default_rng(0)
    for it in range(STEPS):
        i = int(rng.integers(len(data)))
        params, opt_state, loss, aux = step(
            params, opt_state, data[i][0].color, tgts[i]
        )
        if it % 50 == 0 or it == STEPS - 1:
            print(f"step {it}: loss {float(loss):.4f} "
                  f"ce {float(aux['ce']):.4f} center {float(aux['center']):.5f} "
                  f"offset {float(aux['offset']):.3f}", flush=True)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    seg.save_pretrained(OUT, params)
    print("saved", OUT, f"{os.path.getsize(OUT)/1e6:.2f} MB")

    def pix_acc(frame, class_of):
        s = seg.segment(params, frame.color, NUM_CLASSES, 8, WIDTH)
        gt_inst = np.asarray(frame.instance)
        gt_cls = np.asarray(class_of)[np.maximum(gt_inst, 0)]
        gt_cls = np.where(gt_inst > 0, gt_cls, 0)
        pred = np.asarray(s.mask_id)
        cls = np.asarray(s.classes)
        pred_cls = np.where(pred >= 0, cls[np.maximum(pred, 0)], 0)
        return (pred_cls == gt_cls).mean()

    print(f"train frame 0 pixel class acc: {pix_acc(*data[0]):.3f}")
    sc = synthetic.random_scene(HELD_OUT)
    cls = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), sc.kinds.astype(jnp.int32)]
    )
    for intr, tag in ((INTR_320, "320"), (INTR_160, "160")):
        f = synthetic.render_frame_scene(
            jnp.asarray(_poses(8)[3]), intr, sc
        )
        print(f"HELD-OUT seed {HELD_OUT} @{tag}: "
              f"pixel class acc {pix_acc(f, cls):.3f}")


if __name__ == "__main__":
    main()
