"""Rollout generation and policy evaluation.

Equivalent of the brax acting layer the reference's PPO used
(SURVEY §3.4): the rollout is a ``lax.scan`` over env steps under jit, so
an entire unroll (policy apply + batched physics + reward) is one fused
XLA program; the evaluator runs full episodes on a separate batched eval
env and aggregates the ``eval/episode_*`` metrics dict consumed by the
reference ``progress`` callback (/root/reference/pupperv3_mjx/utils.py:
97-100).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
from puppax import struct

from puppax.env.base import State

Policy = Callable[[jnp.ndarray, jax.Array], Tuple[jnp.ndarray, Dict[str, Any]]]


@struct.dataclass
class Transition:
    """One env transition; layout mirrors what the PPO loss consumes."""

    observation: jnp.ndarray
    action: jnp.ndarray  # post-tanh action fed to the env
    reward: jnp.ndarray
    discount: jnp.ndarray  # 1 - done
    next_observation: jnp.ndarray
    truncation: jnp.ndarray  # episode cut off at horizon (not a failure)
    policy_extras: Dict[str, jnp.ndarray]  # log_prob, raw_action (pre-tanh)
    metrics: Dict[str, jnp.ndarray] = struct.field(default_factory=dict)
    # critic-only signals (asymmetric actor-critic): privileged_obs /
    # next_privileged_obs when the env publishes info["privileged_obs"]
    extras: Dict[str, jnp.ndarray] = struct.field(default_factory=dict)


def actor_step(
    env,
    env_state: State,
    policy: Policy,
    key: jax.Array,
    collect_metrics: bool = False,
) -> Tuple[State, Transition]:
    """One policy step on a batched env. ``collect_metrics`` additionally
    records the env's per-step metrics dict (eval only — it widens the
    rollout pytree, so the training path leaves it off)."""
    actions, policy_extras = policy(env_state.obs, key)
    next_state = env.step(env_state, actions)
    extras = {}
    if "privileged_obs" in env_state.info:
        extras = {
            "privileged_obs": env_state.info["privileged_obs"],
            "next_privileged_obs": next_state.info["privileged_obs"],
        }
    return next_state, Transition(
        observation=env_state.obs,
        action=actions,
        reward=next_state.reward,
        discount=1.0 - next_state.done,
        next_observation=next_state.obs,
        truncation=next_state.info["truncation"],
        policy_extras=policy_extras,
        metrics=dict(next_state.metrics) if collect_metrics else {},
        extras=extras,
    )


def generate_unroll(
    env,
    env_state: State,
    policy: Policy,
    key: jax.Array,
    unroll_length: int,
    collect_metrics: bool = False,
) -> Tuple[State, Transition]:
    """Scan ``unroll_length`` actor steps; returns (final_state, stacked
    transitions with leading time axis)."""

    def f(carry, _):
        state, current_key = carry
        current_key, next_key = jax.random.split(current_key)
        next_state, transition = actor_step(
            env, state, policy, current_key, collect_metrics=collect_metrics
        )
        return (next_state, next_key), transition

    (final_state, _), data = jax.lax.scan(
        f, (env_state, key), (), length=unroll_length
    )
    return final_state, data


class Evaluator:
    """Runs full eval episodes and aggregates episode metrics.

    Metric names match the dict the reference's ``progress`` callback reads
    (``eval/episode_reward``, ``eval/episode_reward_std``, per-term
    ``eval/episode_<reward>`` sums, timing fields)."""

    def __init__(
        self,
        eval_env,
        eval_policy_factory: Callable[..., Policy],
        num_eval_envs: int,
        episode_length: int,
        action_repeat: int,
        key: jax.Array,
    ):
        self._key = key
        self._eval_walltime = 0.0
        self._episode_steps = episode_length // action_repeat

        def eval_unroll(policy_params, key):
            # distinct streams: reusing one key for both reset and the
            # action-noise unroll correlates them (ADVICE r1)
            key_reset, key_unroll = jax.random.split(key)
            reset_keys = jax.random.split(key_reset, num_eval_envs)
            eval_state = eval_env.reset(reset_keys)
            policy = eval_policy_factory(policy_params)
            final_state, data = generate_unroll(
                eval_env,
                eval_state,
                policy,
                key_unroll,
                self._episode_steps,
                collect_metrics=True,
            )
            # per-episode sums: mask everything after the first done
            done_mask = jnp.cumsum(data.discount < 0.5, axis=0)
            active = jnp.concatenate(
                [jnp.ones_like(done_mask[:1]), (done_mask < 1)[:-1]], axis=0
            ).astype(data.reward.dtype)
            episode_reward = jnp.sum(data.reward * active, axis=0)
            episode_length_steps = jnp.sum(active, axis=0)
            metrics = {
                "eval/episode_reward": jnp.mean(episode_reward),
                "eval/episode_reward_std": jnp.std(episode_reward),
                "eval/avg_episode_length": jnp.mean(episode_length_steps),
            }
            # per-term episode sums over the active window (brax evaluator
            # semantics: eval/episode_<metric> = mean over envs of the
            # per-episode summed metric)
            for name, series in data.metrics.items():
                if name == "total_dist":
                    # a gauge, not a rate: report the end-of-episode value
                    metrics["eval/episode_total_dist"] = jnp.mean(
                        final_state.metrics[name]
                    )
                    continue
                metrics[f"eval/episode_{name}"] = jnp.mean(
                    jnp.sum(series * active, axis=0)
                )
            return metrics

        self._eval_unroll = jax.jit(eval_unroll)

    def run_evaluation(self, policy_params) -> Dict[str, float]:
        self._key, eval_key = jax.random.split(self._key)
        t = time.perf_counter()
        metrics = jax.device_get(self._eval_unroll(policy_params, eval_key))
        epoch_time = time.perf_counter() - t
        self._eval_walltime += epoch_time
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["eval/walltime"] = self._eval_walltime
        metrics["eval/epoch_eval_time"] = epoch_time
        return metrics
