"""Checkpoint / resume of the full engine state (one npz per step).

The reference has no mid-run persistence — only a final surfel `savePly`
(SURVEY.md §6 "Checkpoint / resume").  Here the whole state is an explicit
pytree (SlamState + BackendState + config digest), so checkpointing is one
npz of its leaves; resume restores and continues bit-exactly.  This is
also the failure-recovery story for multi-device runs: recovery =
restart-from-checkpoint, not in-job elasticity.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

import jax
import numpy as np


def config_digest(cfg: Any) -> str:
    """Stable digest of the frozen config (refuse resume on mismatch)."""
    d = dataclasses.asdict(cfg)
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()[:16]


def save(path: str, state: Any, cfg: Any, step: int) -> None:
    """Save a state pytree + config digest at `path`/step_<N>."""
    os.makedirs(path, exist_ok=True)
    meta = {"step": step, "config": config_digest(cfg)}
    leaves = jax.tree_util.tree_leaves(jax.device_get(state))
    np.savez(
        os.path.join(path, f"step_{step}.npz"),
        **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)},
    )
    with open(os.path.join(path, f"step_{step}.meta.json"), "w") as f:
        json.dump(meta, f)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_") and name.endswith(".meta.json"):
            steps.append(int(name[len("step_"):-len(".meta.json")]))
    return max(steps) if steps else None


def restore(path: str, example_state: Any, cfg: Any, step: int | None = None):
    """Restore the pytree saved by `save`; returns (state, step).

    `example_state` supplies the pytree structure/shapes (allocate a fresh
    state with the same config).  Raises on config digest mismatch.
    """
    step = latest_step(path) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    with open(os.path.join(path, f"step_{step}.meta.json")) as f:
        meta = json.load(f)
    if meta["config"] != config_digest(cfg):
        raise ValueError(
            "checkpoint config mismatch: "
            f"{meta['config']} != {config_digest(cfg)}"
        )
    data = np.load(os.path.join(path, f"step_{step}.npz"))
    leaves, treedef = jax.tree_util.tree_flatten(example_state)
    state = jax.tree_util.tree_unflatten(
        treedef, [data[f"leaf_{i}"] for i in range(len(leaves))]
    )
    return state, step
