"""Batch/episode/auto-reset env wrappers (L3 runtime).

Re-implementation of the brax training wrappers that
``brax.training.agents.ppo.train`` applied around the reference env
(SURVEY §1 L3): episode bookkeeping with truncation, env-batch vmap
(optionally with per-env randomized model leaves — the reference
``randomization_fn`` protocol), and auto-reset.

Auto-reset preserves the brax semantics the reference trained with: on
done, pipeline_state/obs are restored to the state captured at reset time
(NOT a fresh re-randomized reset), while env info (command, latency
buffers) persists — the env itself resets its step counter
(/root/reference/pupperv3_mjx/environment.py:471-476).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from puppax.env.base import Env, State


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env

    def reset(self, rng: jax.Array, **kw) -> State:
        return self.env.reset(rng, **kw)

    def step(self, state: State, action: jax.Array, **kw) -> State:
        return self.env.step(state, action, **kw)

    def __getattr__(self, name):
        if name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)


class EpisodeWrapper(Wrapper):
    """Fixed episode length + action repeat + truncation flag."""

    def __init__(self, env: Env, episode_length: int, action_repeat: int = 1):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def reset(self, rng: jax.Array, **kw) -> State:
        state = self.env.reset(rng, **kw)
        state.info["steps"] = jnp.zeros_like(state.reward)
        state.info["truncation"] = jnp.zeros_like(state.reward)
        return state

    def step(self, state: State, action: jax.Array, **kw) -> State:
        def f(state, _):
            nstate = self.env.step(state, action, **kw)
            return nstate, nstate.reward

        state, rewards = jax.lax.scan(f, state, (), self.action_repeat)
        state = state.replace(reward=jnp.sum(rewards, axis=0))
        steps = state.info["steps"] + self.action_repeat
        one = jnp.ones_like(state.done)
        zero = jnp.zeros_like(state.done)
        done = jnp.where(steps >= self.episode_length, one, state.done)
        info = dict(state.info)
        info["truncation"] = jnp.where(
            steps >= self.episode_length, 1 - state.done, zero
        )
        info["steps"] = steps
        return state.replace(done=done, info=info)


class VmapWrapper(Wrapper):
    """Batch the env over a leading env axis, optionally with per-env
    randomized model leaves (the reference randomization_fn protocol,
    /root/reference/pupperv3_mjx/domain_randomization.py:93-112)."""

    def __init__(self, env: Env, batched_model=None, model_in_axes=None):
        super().__init__(env)
        self._model = batched_model
        self._in_axes = model_in_axes

    def reset(self, rng: jax.Array) -> State:
        if self._model is not None:
            return jax.vmap(
                lambda m, r: self.env.reset(r, model=m),
                in_axes=(self._in_axes, 0),
            )(self._model, rng)
        return jax.vmap(self.env.reset)(rng)

    def step(self, state: State, action: jax.Array) -> State:
        if self._model is not None:
            return jax.vmap(
                lambda m, s, a: self.env.step(s, a, model=m),
                in_axes=(self._in_axes, 0, 0),
            )(self._model, state, action)
        return jax.vmap(self.env.step)(state, action)


class AutoResetWrapper(Wrapper):
    """brax-semantics auto-reset: restore the reset-time state on done.

    The FULL PhysicsState is restored with a tree-mapped ``where(done)``
    (brax's approach). Restoring only qpos/qvel/obs, on the theory that
    the derived leaves are recomputed anyway, breaks XLA's carry aliasing
    for the large contact/FK buffers in the rollout scan, which costs far
    more than the where() writes it saves.
    """

    def reset(self, rng: jax.Array) -> State:
        state = self.env.reset(rng)
        info = dict(state.info)
        info["first_pipeline_state"] = state.pipeline_state
        info["first_obs"] = state.obs
        if "privileged_obs" in info:
            info["first_privileged_obs"] = info["privileged_obs"]
        return state.replace(info=info)

    def step(self, state: State, action: jax.Array) -> State:
        info = dict(state.info)
        if "steps" in info:
            info["steps"] = jnp.where(
                state.done, jnp.zeros_like(info["steps"]), info["steps"]
            )
        state = state.replace(done=jnp.zeros_like(state.done), info=info)
        state = self.env.step(state, action)

        def where_done(x, y):
            done = state.done
            if done.ndim > 0:
                done = jnp.reshape(done, [x.shape[0]] + [1] * (len(x.shape) - 1))
            return jnp.where(done, x, y)

        pipeline_state = jax.tree_util.tree_map(
            where_done,
            state.info["first_pipeline_state"],
            state.pipeline_state,
        )
        obs = where_done(state.info["first_obs"], state.obs)
        state = state.replace(pipeline_state=pipeline_state, obs=obs)
        if "gait_phase" in state.info:
            # restart the gait clock with the episode: the restored
            # first_obs tail reads phase 0, and the next step then shows
            # dphi — exactly the fresh-reset sequence (and the deployed
            # runtime's reset_clock()). Keyed on the EFFECTIVE done, which
            # includes EpisodeWrapper time limits the env can't see.
            info = dict(state.info)
            info["gait_phase"] = jnp.where(
                state.done > 0.5, jnp.zeros_like(info["gait_phase"]),
                info["gait_phase"],
            )
            state = state.replace(info=info)
        if "privileged_obs" in state.info:
            info = dict(state.info)
            info["privileged_obs"] = where_done(
                info["first_privileged_obs"], info["privileged_obs"]
            )
            state = state.replace(info=info)
        return state


def wrap_for_training(
    env: Env,
    episode_length: int = 1000,
    action_repeat: int = 1,
    randomization_fn: Optional[Callable] = None,
    randomization_rng: Optional[jax.Array] = None,
) -> Env:
    """Episode + (DR-)Vmap + AutoReset, the stack brax PPO applied
    (SURVEY §3.4). ``randomization_fn(model, rng) -> (model, in_axes)``."""
    wrapped = EpisodeWrapper(env, episode_length, action_repeat)
    if randomization_fn is not None:
        batched_model, in_axes = randomization_fn(env.model, randomization_rng)
        wrapped = VmapWrapper(wrapped, batched_model, in_axes)
    else:
        wrapped = VmapWrapper(wrapped)
    return AutoResetWrapper(wrapped)
