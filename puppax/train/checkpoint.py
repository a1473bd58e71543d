"""Checkpoint save/restore (``<checkpoint_path>/<step>/`` layout).

Mirrors the reference's checkpoint story (/root/reference/pupperv3_mjx/
utils.py:202-211: one pytree per per-step directory, optionally mirrored
to an artifact store) and extends it with full train-state resume
(params + optimizer + normalizer), the gap SURVEY §5 calls out. The
per-step directory layout is kept because the export tooling walks it.

Each step directory holds one ``checkpoint.npz``: the pytree's leaves,
keyed by their path ("normalizer/mean", "1/policy/params/hidden_0/kernel").
Restoring with a ``target`` pytree rebuilds that exact structure; without
one it returns nested dicts, with lists where every key is an index.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np

_FILE = "checkpoint.npz"


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported pytree key {k!r}")


def _flat(tree: Any) -> Dict[str, np.ndarray]:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {
        "/".join(_key_name(k) for k in path): np.asarray(leaf)
        for path, leaf in leaves
    }


def _nest(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for name, value in flat.items():
        node = root
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_checkpoint(current_step: int, params: Any, checkpoint_path) -> str:
    """Save a param pytree under ``checkpoint_path/<step>/`` (reference
    utils.py:202-211 semantics). The artifact-store upload lives in
    ``MetricsLogger.log_artifact`` (puppax/tools/metrics.py), wired after
    each save by scripts/train.py — not here."""
    path = (Path(checkpoint_path) / str(current_step)).resolve()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **_flat(jax.device_get(params)))
    os.replace(tmp, path / _FILE)
    return str(path)


def latest_checkpoint_step(checkpoint_path) -> Optional[int]:
    """Highest-step subdirectory, or None (reference download_checkpoint
    picks the max step suffix, utils.py:352-360)."""
    p = Path(checkpoint_path)
    if not p.is_dir():
        return None
    steps = [int(d.name) for d in p.iterdir() if d.is_dir() and d.name.isdigit()]
    return max(steps) if steps else None


def download_checkpoint(
    project_name: str,
    entity_name: str,
    run_number: int,
    save_path="checkpoint",
):
    """Fetch the highest-step checkpoint artifact of a W&B run
    (reference utils.py:316-368 behavior: match run by ``-<run_number>``
    suffix, pick the max ``checkpoint_*_<step>`` artifact). Requires wandb
    to be installed and configured; raises ImportError otherwise."""
    import wandb

    api = wandb.Api()
    runs = [
        r
        for r in api.runs(f"{entity_name}/{project_name}")
        if r.name.endswith(f"-{run_number}")
    ]
    if not runs:
        raise LookupError(f"no run ending in -{run_number}")
    artifacts = [
        a for a in runs[0].logged_artifacts() if "checkpoint" in a.name
    ]
    if not artifacts:
        raise LookupError("run has no checkpoint artifacts")
    latest = max(artifacts, key=lambda a: int(a.name.split("_")[-1].split(":")[0]))
    latest.download(str(save_path))
    return str(save_path)


def restore_checkpoint(checkpoint_path, step: Optional[int] = None, target: Any = None):
    """Restore the params saved at ``step`` (default: latest)."""
    if step is None:
        step = latest_checkpoint_step(checkpoint_path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {checkpoint_path}")
    path = (Path(checkpoint_path) / str(step)).resolve() / _FILE
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if target is None:
        return _nest(flat)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    names = ["/".join(_key_name(k) for k in p) for p, _ in leaves]
    missing = [n for n in names if n not in flat]
    if missing or len(names) != len(flat):
        raise ValueError(
            f"checkpoint {path} does not match the target structure "
            f"(missing {missing[:5]}, {len(flat)} saved vs {len(names)} leaves)"
        )
    return jax.tree_util.tree_unflatten(
        treedef,
        [np.asarray(flat[n], dtype=np.asarray(leaf).dtype)
         for n, (_, leaf) in zip(names, leaves)],
    )
