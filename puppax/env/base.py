"""Env runtime base: the State pytree and the Env interface (L3).

Replacement for ``brax.envs.base`` (PipelineEnv/State) that the
reference builds on (/root/reference/pupperv3_mjx/environment.py:7,344).
State mirrors the brax State surface the reference code touches:
(pipeline_state, obs, reward, done, metrics, info) plus ``.replace`` and
dotted-path ``.tree_replace`` (environment.py:356).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
from puppax import struct

from puppax.physics.pipeline import PhysicsState


@struct.dataclass
class State:
    """Per-env environment state pytree."""

    pipeline_state: PhysicsState
    obs: jax.Array
    reward: jax.Array
    done: jax.Array
    metrics: Dict[str, jax.Array]
    info: Dict[str, Any]

    def tree_replace(self, updates: Dict[str, Any]) -> "State":
        """Dotted-path functional update, e.g.
        ``state.tree_replace({'pipeline_state.qvel': qvel})``
        (brax-compatible, used at environment.py:356)."""
        out = self
        for path, value in updates.items():
            parts = path.split(".")
            out = _replace_path(out, parts, value)
        return out


def _replace_path(obj, parts, value):
    if len(parts) == 1:
        if isinstance(obj, dict):
            new = dict(obj)
            new[parts[0]] = value
            return new
        return obj.replace(**{parts[0]: value})
    child = obj[parts[0]] if isinstance(obj, dict) else getattr(obj, parts[0])
    new_child = _replace_path(child, parts[1:], value)
    if isinstance(obj, dict):
        new = dict(obj)
        new[parts[0]] = new_child
        return new
    return obj.replace(**{parts[0]: new_child})


class Env:
    """Minimal env interface: reset(rng) -> State, step(State, action) -> State."""

    def reset(self, rng: jax.Array) -> State:
        raise NotImplementedError

    def step(self, state: State, action: jax.Array) -> State:
        raise NotImplementedError

    @property
    def dt(self) -> float:
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        raise NotImplementedError
