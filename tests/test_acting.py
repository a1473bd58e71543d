"""Evaluator semantics tests on a stub env: per-episode metric sums,
active-window masking after done, episode length accounting."""

import jax
import jax.numpy as jnp
import numpy as np
from puppax import struct

from puppax.env.base import Env, State
from puppax.train import acting


@struct.dataclass
class _StubPS:
    t: jnp.ndarray


class StubEnv(Env):
    """Batched env: reward 1 per step, metric m = step index, terminates
    (done=1) at step `horizon`."""

    def __init__(self, horizon: int):
        self.horizon = horizon

    @property
    def dt(self):
        return 0.02

    def reset(self, rng):
        # rng: (B, 2) keys -> batch size B
        batch = rng.shape[0]
        t = jnp.zeros(batch)
        return State(
            pipeline_state=_StubPS(t=t),
            obs=jnp.zeros((batch, 3)),
            reward=jnp.zeros(batch),
            done=jnp.zeros(batch),
            metrics={"m": jnp.zeros(batch)},
            info={"truncation": jnp.zeros(batch)},
        )

    def step(self, state, action):
        t = state.pipeline_state.t + 1.0
        done = (t >= self.horizon).astype(jnp.float32)
        return state.replace(
            pipeline_state=_StubPS(t=t),
            reward=jnp.ones_like(t),
            done=done,
            metrics={"m": t},
        )


def test_evaluator_episode_sums_mask_after_done():
    env = StubEnv(horizon=3)
    policy_factory = lambda params: (  # noqa: E731
        lambda obs, rng: (jnp.zeros(obs.shape[:-1] + (2,)), {})
    )
    evaluator = acting.Evaluator(
        env,
        policy_factory,
        num_eval_envs=4,
        episode_length=6,  # longer than the horizon: masking must kick in
        action_repeat=1,
        key=jax.random.PRNGKey(0),
    )
    metrics = evaluator.run_evaluation(None)
    # episode = steps 1..3 (done at t=3): reward sum 3, m sum 1+2+3=6
    assert metrics["eval/episode_reward"] == 3.0
    assert metrics["eval/avg_episode_length"] == 3.0
    assert metrics["eval/episode_m"] == 6.0
    np.testing.assert_allclose(metrics["eval/episode_reward_std"], 0.0, atol=1e-6)
    assert metrics["eval/walltime"] > 0.0
