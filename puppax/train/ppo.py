"""PPO learner — mesh-sharded, single jit region per training epoch.

Replacement for the brax PPO trainer the reference invoked
(SURVEY §3.4): same algorithm family (clipped surrogate + GAE + running
obs normalization + entropy bonus, truncation-aware bootstrapping) and the
same callback/param surface (``progress_fn(step, metrics)``,
``policy_params_fn(step, make_policy, params)``,
``randomization_fn(model, rng) -> (batched_model, in_axes)``), but a
different parallelization design:

* brax ``pmap``s the learner over local devices with explicit ``psum``;
  here the whole training epoch is ONE ``jit`` region with
  ``NamedSharding`` annotations over a global ``Mesh(('env',))`` — the env
  batch is sharded over all devices, params
  are replicated, and XLA GSPMD inserts the gradient all-reduce and the
  minibatch-shuffle collectives. This scales past one host with no code
  change (``jax.distributed`` + a bigger mesh).
* rollout, GAE, and the SGD epochs are ``lax.scan``s inside that one jit
  region — no host round-trips between rollout and update.

Hyperparameter defaults follow the brax PPO defaults the reference
trained with; the loss coefficients (0.25 value-loss factor, single-sample
entropy estimate) reproduce its training dynamics.
"""

from __future__ import annotations

import functools
import math as pymath
import time
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from puppax import backend, struct
from jax.sharding import NamedSharding, PartitionSpec as P

from puppax.env import wrappers
from puppax.parallel import mesh as mesh_lib
from puppax.train import acting, networks as ppo_networks, running_statistics
from puppax.train.acting import Transition

Metrics = Dict[str, jnp.ndarray]


_STEP_BASE = 2**30


@struct.dataclass
class StepCount:
    """int64-safe step counter as two int32 limbs (base 2**30).

    Training never enables jax_enable_x64, so a plain int32 counter wraps
    negative at ~2.15 B env steps — one doubling past the 1 B runs already
    on record (ADVICE r1). Two limbs count to 2**60 without x64.
    """

    hi: jnp.ndarray
    lo: jnp.ndarray

    @classmethod
    def zero(cls) -> "StepCount":
        return cls(hi=jnp.zeros((), jnp.int32), lo=jnp.zeros((), jnp.int32))

    def add(self, inc: int) -> "StepCount":
        if not 0 <= inc < _STEP_BASE:
            raise ValueError(f"increment {inc} out of range [0, 2**30)")
        lo = self.lo + jnp.int32(inc)
        return StepCount(hi=self.hi + lo // _STEP_BASE, lo=lo % _STEP_BASE)

    def to_int(self) -> int:
        """Host-side read as a Python int (arbitrary precision)."""
        return int(self.hi) * _STEP_BASE + int(self.lo)


@struct.dataclass
class TrainingState:
    optimizer_state: optax.OptState
    params: ppo_networks.PPONetworkParams
    normalizer_params: running_statistics.RunningStatisticsState
    env_steps: StepCount
    # asymmetric actor-critic only: running stats over the critic's
    # [obs, privileged] input (None when the critic sees policy obs —
    # None is an empty pytree node, so the disabled-path checkpoint
    # structure is unchanged)
    critic_normalizer_params: Optional[
        running_statistics.RunningStatisticsState
    ] = None


def compute_gae(
    truncation: jnp.ndarray,
    termination: jnp.ndarray,
    rewards: jnp.ndarray,
    values: jnp.ndarray,
    bootstrap_value: jnp.ndarray,
    lambda_: float,
    discount: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Truncation-aware Generalized Advantage Estimation over (T, B) data.

    ``termination`` ends the value bootstrap (failure), ``truncation``
    masks the TD error entirely (episode cut at horizon — the next value
    belongs to a different episode, so neither bootstrap nor delta apply).
    Returns (value targets, advantages), both stop-gradiented.
    """
    truncation_mask = 1.0 - truncation
    values_t_plus_1 = jnp.concatenate([values[1:], bootstrap_value[None]], axis=0)
    deltas = rewards + discount * (1.0 - termination) * values_t_plus_1 - values
    deltas *= truncation_mask

    def body(acc, xs):
        delta, term, trunc_mask = xs
        acc = delta + discount * (1.0 - term) * trunc_mask * lambda_ * acc
        return acc, acc

    _, vs_minus_v = jax.lax.scan(
        body,
        jnp.zeros_like(bootstrap_value),
        (deltas, termination, truncation_mask),
        reverse=True,
    )
    vs = vs_minus_v + values
    vs_t_plus_1 = jnp.concatenate([vs[1:], bootstrap_value[None]], axis=0)
    advantages = (
        rewards + discount * (1.0 - termination) * vs_t_plus_1 - values
    ) * truncation_mask
    return jax.lax.stop_gradient(vs), jax.lax.stop_gradient(advantages)


def train(
    environment,
    num_timesteps: int,
    episode_length: int,
    num_envs: int = 4096,
    num_eval_envs: int = 128,
    action_repeat: int = 1,
    learning_rate: float = 3e-4,
    lr_schedule: str = "constant",  # constant | cosine | linear
    lr_final_fraction: float = 0.0,
    entropy_cost: float = 1e-2,
    entropy_schedule: str = "constant",  # constant | linear
    entropy_cost_final: float = 0.0,
    discounting: float = 0.97,
    unroll_length: int = 20,
    batch_size: int = 256,
    num_minibatches: int = 32,
    num_updates_per_batch: int = 4,
    reward_scaling: float = 1.0,
    clipping_epsilon: float = 0.3,
    gae_lambda: float = 0.95,
    normalize_advantage: bool = True,
    normalize_observations: bool = True,
    lazy_shuffle: bool = False,
    max_grad_norm: Optional[float] = None,
    seed: int = 0,
    num_evals: int = 1,
    deterministic_eval: bool = False,
    network_factory: Callable = ppo_networks.make_ppo_networks,
    privileged_critic: bool = False,
    curriculum_steps: int = 0,
    randomization_fn: Optional[Callable] = None,
    progress_fn: Callable[[int, Metrics], None] = lambda *args: None,
    policy_params_fn: Callable[..., None] = lambda *args: None,
    eval_env=None,
    devices=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    metrics_logger=None,
):
    """Train a PPO policy; returns (make_policy, params, metrics).

    ``checkpoint_dir`` enables full train-state checkpointing (params +
    optimizer + normalizer + env_steps) at every eval epoch under
    ``<checkpoint_dir>/state/<env_steps>/`` (the ``state/`` subdir keeps
    it apart from export-style param checkpoints a ``policy_params_fn``
    may write at ``<checkpoint_dir>/<step>/``); with ``resume=True``
    training restarts from the latest such checkpoint (envs re-reset —
    rollout state is regenerated, which PPO's on-policy updates
    tolerate).

    ``params`` is ``(normalizer_state, PPONetworkParams)``; pass
    ``(params[0], params[1].policy)`` to ``make_policy`` — the reference's
    checkpoint/export contract (utils.py:242, export.py:29).
    """
    device_mesh = mesh_lib.make_env_mesh(devices)
    num_devices = device_mesh.size
    assert num_envs % num_devices == 0, (num_envs, num_devices)

    env_step_per_training_step = (
        batch_size * unroll_length * num_minibatches * action_repeat
    )
    num_evals_after_init = max(num_evals - 1, 1)
    num_training_steps_per_epoch = max(
        1,
        pymath.ceil(
            num_timesteps / (num_evals_after_init * env_step_per_training_step)
        ),
    )
    assert (batch_size * num_minibatches) % num_envs == 0
    num_unrolls_per_env = (batch_size * num_minibatches) // num_envs

    key = jax.random.PRNGKey(seed)
    key, network_key, env_key, eval_key = jax.random.split(key, 4)

    # --- env (episode + DR-vmap + auto-reset, SURVEY §3.4) ---------------
    key_dr = None
    if randomization_fn is not None:
        key, key_dr = jax.random.split(key)
        key_dr = jax.random.split(key_dr, num_envs)
    env = wrappers.wrap_for_training(
        environment,
        episode_length=episode_length,
        action_repeat=action_repeat,
        randomization_fn=randomization_fn,
        randomization_rng=key_dr,
    )

    obs_size = environment.observation_size
    action_size = environment.action_size

    # the rollout steps envs on the per-env XLA engine; step_path raises
    # on a platform puppax has no step path for (puppax/backend.py)
    path = backend.step_path()
    if jax.process_index() == 0:
        print(
            f"[puppax.ppo] rollout step path: {path} on "
            f"{jax.default_backend()!r} (devices={num_devices})",
            flush=True,
        )

    # --- networks + optimizer -------------------------------------------
    if privileged_critic:
        assert getattr(environment, "_privileged_obs", False), (
            "privileged_critic=True requires the env to publish "
            "info['privileged_obs'] (PupperV3Env(privileged_obs=True))"
        )
        priv_size = environment.privileged_obs_size
        ppo_network = network_factory(
            obs_size, action_size, privileged_size=priv_size
        )
    else:
        priv_size = 0
        ppo_network = network_factory(obs_size, action_size)
    make_policy = ppo_networks.make_inference_fn(ppo_network)
    dist = ppo_network.action_distribution

    # total optimizer updates over the run (drives the lr schedule)
    total_updates = (
        num_training_steps_per_epoch
        * num_evals_after_init
        * num_updates_per_batch
        * num_minibatches
    )
    if lr_schedule == "cosine":
        lr = optax.cosine_decay_schedule(
            learning_rate, decay_steps=total_updates, alpha=lr_final_fraction
        )
    elif lr_schedule == "linear":
        lr = optax.linear_schedule(
            learning_rate, learning_rate * lr_final_fraction, total_updates
        )
    elif lr_schedule == "constant":
        lr = learning_rate
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    if max_grad_norm is not None:
        optimizer = optax.chain(
            optax.clip_by_global_norm(max_grad_norm),
            optax.adam(learning_rate=lr),
        )
    else:
        optimizer = optax.adam(learning_rate=lr)
    if entropy_schedule not in ("constant", "linear"):
        raise ValueError(f"unknown entropy_schedule {entropy_schedule!r}")

    # --- shardings -------------------------------------------------------
    replicated = NamedSharding(device_mesh, P())
    env_sharded = NamedSharding(device_mesh, P(mesh_lib.ENV_AXIS))
    time_batch = P(None, mesh_lib.ENV_AXIS)

    def constrain(tree, spec: P):
        s = NamedSharding(device_mesh, spec)
        return jax.tree_util.tree_map(
            lambda x: jax.lax.with_sharding_constraint(x, s), tree
        )

    # --- loss ------------------------------------------------------------
    def compute_ppo_loss(
        params: ppo_networks.PPONetworkParams,
        norms,  # (policy normalizer, critic normalizer or None)
        data: Transition,
        rng: jax.Array,
        entropy_cost_now,
    ) -> Tuple[jnp.ndarray, Metrics]:
        normalizer_params, critic_norm = norms
        # data is time-major (T, mb, ...)
        policy_logits = ppo_network.policy_network.apply(
            normalizer_params if normalize_observations else None,
            params.policy,
            data.observation,
        )
        if privileged_critic:
            # asymmetric actor-critic: the value net additionally sees the
            # ground-truth privileged signals recorded during the rollout
            critic_obs = jnp.concatenate(
                [data.observation, data.extras["privileged_obs"]], axis=-1
            )
            critic_boot = jnp.concatenate(
                [data.next_observation[-1], data.extras["next_privileged_obs"][-1]],
                axis=-1,
            )
            cn = critic_norm
        else:
            critic_obs = data.observation
            critic_boot = data.next_observation[-1]
            cn = normalizer_params
        baseline = ppo_network.value_network.apply(
            cn if normalize_observations else None,
            params.value,
            critic_obs,
        )
        bootstrap_value = ppo_network.value_network.apply(
            cn if normalize_observations else None,
            params.value,
            critic_boot,
        )

        rewards = data.reward * reward_scaling
        truncation = data.truncation
        termination = (1.0 - data.discount) * (1.0 - truncation)

        target_lp = dist.log_prob(policy_logits, data.policy_extras["raw_action"])
        behaviour_lp = data.policy_extras["log_prob"]

        vs, advantages = compute_gae(
            truncation=truncation,
            termination=termination,
            rewards=rewards,
            values=baseline,
            bootstrap_value=bootstrap_value,
            lambda_=gae_lambda,
            discount=discounting,
        )
        if normalize_advantage:
            advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)

        rho = jnp.exp(target_lp - behaviour_lp)
        surrogate = rho * advantages
        clipped = (
            jnp.clip(rho, 1.0 - clipping_epsilon, 1.0 + clipping_epsilon) * advantages
        )
        policy_loss = -jnp.mean(jnp.minimum(surrogate, clipped))

        v_error = vs - baseline
        value_loss = 0.25 * jnp.mean(v_error * v_error)

        entropy = jnp.mean(dist.entropy(policy_logits, rng))
        entropy_loss = -entropy_cost_now * entropy

        total = policy_loss + value_loss + entropy_loss
        return total, {
            "total_loss": total,
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy_loss": entropy_loss,
        }

    grad_fn = jax.value_and_grad(compute_ppo_loss, has_aux=True)

    # --- SGD over minibatches -------------------------------------------
    def minibatch_step(carry, data: Transition):
        opt_state, params, normalizer_params, key_, ec_now = carry
        key_, key_loss = jax.random.split(key_)
        (_, metrics), grads = grad_fn(
            params, normalizer_params, data, key_loss, ec_now
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (opt_state, params, normalizer_params, key_, ec_now), metrics

    def _shuffle_data(x, perm):
        # (T, B, ...) -> (M, T, mb, ...): global shuffle over the
        # sharded batch axis (GSPMD lowers the gather to collectives)
        x = jnp.take(x, perm, axis=1)
        x = x.reshape((x.shape[0], num_minibatches, batch_size) + x.shape[2:])
        x = jnp.swapaxes(x, 0, 1)
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(device_mesh, P(None, None, mesh_lib.ENV_AXIS))
        )

    def sgd_step(carry, _, data: Transition):
        opt_state, params, normalizer_params, key_, ec_now = carry
        key_, key_perm, key_grad = jax.random.split(key_, 3)

        total_batch = batch_size * num_minibatches
        perm = jax.random.permutation(key_perm, total_batch)

        if lazy_shuffle:
            # Same permutation, same minibatch rows, same order — but the
            # gather happens PER MINIBATCH inside the scan instead of
            # materializing the full (M, T, mb, ...) shuffled tensor up
            # front. This skips the eager full-data take + reshape +
            # swapaxes relayouts at the price of M smaller gathers that
            # XLA can overlap with the minibatch compute. Bit-identical
            # training trajectory to the eager path by construction
            # (tests/test_train.py::test_lazy_shuffle_bit_parity).
            perm_mb = perm.reshape((num_minibatches, batch_size))

            def _lazy_minibatch_step(carry, idx):
                mb = jax.tree_util.tree_map(
                    lambda x: jax.lax.with_sharding_constraint(
                        jnp.take(x, idx, axis=1),
                        NamedSharding(device_mesh, time_batch),
                    ),
                    data,
                )
                return minibatch_step(carry, mb)

            (opt_state, params, _, _, _), metrics = jax.lax.scan(
                _lazy_minibatch_step,
                (opt_state, params, normalizer_params, key_grad, ec_now),
                perm_mb,
                length=num_minibatches,
            )
            return (
                opt_state, params, normalizer_params, key_, ec_now
            ), metrics

        shuffled = jax.tree_util.tree_map(
            lambda x: _shuffle_data(x, perm), data
        )
        (opt_state, params, _, _, _), metrics = jax.lax.scan(
            minibatch_step,
            (opt_state, params, normalizer_params, key_grad, ec_now),
            shuffled,
            length=num_minibatches,
        )
        return (opt_state, params, normalizer_params, key_, ec_now), metrics

    def _reorder_data(x):
        # (U, T, B_env, ...) -> (T, U*B_env, ...) time-major flat batch
        x = jnp.swapaxes(x, 0, 1)
        x = x.reshape((x.shape[0], -1) + x.shape[3:])
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(device_mesh, time_batch)
        )

    def _rollout_scan(training_state, env_state, key_unroll):
        """The rollout half of a training step: num_unrolls_per_env
        unrolls, returning (env_state, (U, T, B)
        transition stack)."""
        policy_params = (
            training_state.normalizer_params if normalize_observations else None,
            training_state.params.policy,
        )
        policy = make_policy(policy_params)

        def roll(carry_, _unused):
            state, k = carry_
            k, k_unroll = jax.random.split(k)
            next_state, data = acting.generate_unroll(
                env, state, policy, k_unroll, unroll_length
            )
            return (next_state, k), data

        (env_state, _), data = jax.lax.scan(
            roll, (env_state, key_unroll), (), length=num_unrolls_per_env
        )
        return env_state, data

    # --- one training step: rollout + normalizer update + SGD epochs ----
    def training_step(carry, _):
        training_state, env_state, key_ = carry
        key_, key_sgd, key_unroll = jax.random.split(key_, 3)

        if curriculum_steps > 0:
            # disturbance curriculum: ramp kick/noise 0 -> 1 with env-step
            # progress, IN-GRAPH per training step (an epoch-granular
            # host-side update would leave a num_evals=1 run at
            # difficulty 0 for its entire single epoch). Elementwise
            # update keeps the per-env sharding.
            steps_f = (
                training_state.env_steps.hi.astype(jnp.float32) * _STEP_BASE
                + training_state.env_steps.lo.astype(jnp.float32)
            )
            d = jnp.clip(steps_f / float(curriculum_steps), 0.0, 1.0)
            env_state = env_state.replace(info={
                **env_state.info,
                "difficulty": env_state.info["difficulty"] * 0.0 + d,
            })

        env_state, data = _rollout_scan(training_state, env_state, key_unroll)
        data = jax.tree_util.tree_map(_reorder_data, data)

        normalizer_params = training_state.normalizer_params
        critic_normalizer = training_state.critic_normalizer_params
        if normalize_observations:
            normalizer_params = running_statistics.update(
                normalizer_params, data.observation
            )
            if privileged_critic:
                critic_normalizer = running_statistics.update(
                    critic_normalizer,
                    jnp.concatenate(
                        [data.observation, data.extras["privileged_obs"]],
                        axis=-1,
                    ),
                )

        if entropy_schedule == "linear":
            steps_f = (
                training_state.env_steps.hi.astype(jnp.float32) * _STEP_BASE
                + training_state.env_steps.lo.astype(jnp.float32)
            )
            progress = jnp.clip(steps_f / float(num_timesteps), 0.0, 1.0)
            ec_now = entropy_cost + (entropy_cost_final - entropy_cost) * progress
        else:
            ec_now = jnp.asarray(entropy_cost, jnp.float32)

        (opt_state, params, _, _, _), sgd_metrics = jax.lax.scan(
            functools.partial(sgd_step, data=data),
            (
                training_state.optimizer_state,
                training_state.params,
                (normalizer_params, critic_normalizer),
                key_sgd,
                ec_now,
            ),
            (),
            length=num_updates_per_batch,
        )
        metrics = jax.tree_util.tree_map(jnp.mean, sgd_metrics)

        new_training_state = TrainingState(
            optimizer_state=opt_state,
            params=params,
            normalizer_params=normalizer_params,
            env_steps=training_state.env_steps.add(env_step_per_training_step),
            critic_normalizer_params=critic_normalizer,
        )
        return (new_training_state, env_state, key_), metrics

    def training_epoch(training_state, env_state, key_):
        (training_state, env_state, _), metrics = jax.lax.scan(
            training_step,
            (training_state, env_state, key_),
            (),
            length=num_training_steps_per_epoch,
        )
        metrics = jax.tree_util.tree_map(jnp.mean, metrics)
        return training_state, env_state, metrics

    epoch_fn = jax.jit(
        training_epoch,
        in_shardings=(replicated, env_sharded, replicated),
        out_shardings=(replicated, env_sharded, replicated),
        donate_argnums=(0, 1),
    )

    # --- init ------------------------------------------------------------
    key_policy, key_value = jax.random.split(network_key)
    init_params = ppo_networks.PPONetworkParams(
        policy=ppo_network.policy_network.init(key_policy),
        value=ppo_network.value_network.init(key_value),
    )
    training_state = TrainingState(
        optimizer_state=optimizer.init(init_params),
        params=init_params,
        normalizer_params=running_statistics.init_state(obs_size),
        env_steps=StepCount.zero(),
        critic_normalizer_params=(
            running_statistics.init_state(obs_size + priv_size)
            if privileged_critic
            else None
        ),
    )
    if resume and checkpoint_dir is not None:
        import os as _os

        from puppax.train import checkpoint as ckpt_lib

        state_dir = _os.path.join(str(checkpoint_dir), "state")
        step = ckpt_lib.latest_checkpoint_step(state_dir)
        if step is not None:
            training_state = ckpt_lib.restore_checkpoint(
                state_dir, step=step, target=training_state
            )
    training_state = jax.device_put(training_state, replicated)

    reset_fn = jax.jit(env.reset, out_shardings=env_sharded)
    env_keys = jax.random.split(env_key, num_envs)
    env_state = reset_fn(env_keys)

    # --- evaluator -------------------------------------------------------
    if eval_env is None:
        eval_env = environment
    wrapped_eval_env = wrappers.wrap_for_training(
        eval_env, episode_length=episode_length, action_repeat=action_repeat
    )
    evaluator = acting.Evaluator(
        wrapped_eval_env,
        functools.partial(make_policy, deterministic=deterministic_eval),
        num_eval_envs=num_eval_envs,
        episode_length=episode_length,
        action_repeat=action_repeat,
        key=eval_key,
    )

    def _callback_params(ts: TrainingState):
        return (ts.normalizer_params, ts.params)

    # --- phase profiler (opt-in) ----------------------------------------
    # PUPPAX_PPO_PROFILE=1: time each phase of one training step in
    # isolation (rollout / reorder / normalizer / SGD incl. shuffle / full
    # step) before the run starts, printing one JSON line. This is the
    # learner-overhead attribution tool (VERDICT r4 weakness 5: ~37% gap
    # between the rollout bench and end-to-end SPS had no profile).
    # block_until_ready only — no D2H reads before the timings are done.
    import os as _os

    if _os.environ.get("PUPPAX_PPO_PROFILE") and jax.process_index() == 0:
        import json as _json
        import sys as _sys

        def _timeit(fn, *args, reps=3):
            out = fn(*args)  # compile
            jax.block_until_ready(out)
            ts_ = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = fn(*args)
                jax.block_until_ready(out)
                ts_.append(time.perf_counter() - t0)
            return sorted(ts_)[reps // 2], out

        _key_p = jax.random.PRNGKey(123)
        roll_fn = jax.jit(_rollout_scan)
        t_roll, (_, data_u) = _timeit(roll_fn, training_state, env_state, _key_p)
        reorder_fn = jax.jit(
            lambda d: jax.tree_util.tree_map(_reorder_data, d)
        )
        t_reorder, data_f = _timeit(reorder_fn, data_u)
        norm_fn = jax.jit(running_statistics.update)
        t_norm, _ = _timeit(
            norm_fn, training_state.normalizer_params, data_f.observation
        )

        def _sgd_only(ts_in, data, k):
            ec0 = jnp.asarray(entropy_cost, jnp.float32)
            (opt_state, params, _, _, _), m = jax.lax.scan(
                functools.partial(sgd_step, data=data),
                (
                    ts_in.optimizer_state,
                    ts_in.params,
                    (ts_in.normalizer_params, ts_in.critic_normalizer_params),
                    k,
                    ec0,
                ),
                (),
                length=num_updates_per_batch,
            )
            return opt_state, params, m

        t_sgd, _ = _timeit(jax.jit(_sgd_only), training_state, data_f, _key_p)

        def _shuffle_only(data, k):
            perm = jax.random.permutation(k, batch_size * num_minibatches)
            return jax.tree_util.tree_map(
                lambda x: _shuffle_data(x, perm), data
            )

        t_shuffle, _ = _timeit(jax.jit(_shuffle_only), data_f, _key_p)
        step_fn = jax.jit(lambda ts_, es_, k: training_step((ts_, es_, k), None))
        t_full, _ = _timeit(step_fn, training_state, env_state, _key_p)

        es_per_step = env_step_per_training_step
        print(
            "[puppax.ppo] phase profile: "
            + _json.dumps(
                {
                    "t_rollout_s": round(t_roll, 4),
                    "t_reorder_s": round(t_reorder, 4),
                    "t_normalizer_s": round(t_norm, 4),
                    "t_sgd_s": round(t_sgd, 4),
                    "t_shuffle_per_update_s": round(t_shuffle, 4),
                    "t_full_step_s": round(t_full, 4),
                    "sum_phases_s": round(t_roll + t_reorder + t_norm + t_sgd, 4),
                    "env_steps_per_training_step": es_per_step,
                    "sps_rollout_only": round(es_per_step / t_roll),
                    "sps_full_step": round(es_per_step / t_full),
                },
            ),
            file=_sys.stderr,
            flush=True,
        )

    # --- main loop -------------------------------------------------------
    all_metrics: Dict[str, float] = {}
    current_step = 0

    if num_evals > 1:
        metrics = evaluator.run_evaluation(
            (training_state.normalizer_params, training_state.params.policy)
        )
        progress_fn(0, metrics)
        all_metrics = metrics

    if curriculum_steps > 0 and "difficulty" not in env_state.info:
        raise ValueError(
            "curriculum_steps > 0 requires an environment with "
            "disturbance_curriculum=True (info['difficulty'] missing)"
        )

    for _ in range(num_evals_after_init):
        if jax.device_get(training_state.env_steps).to_int() >= num_timesteps:
            break  # resumed past the target
        key, epoch_key = jax.random.split(key)
        t = time.perf_counter()
        training_state, env_state, train_metrics = epoch_fn(
            training_state, env_state, epoch_key
        )
        train_metrics = jax.device_get(train_metrics)
        epoch_time = time.perf_counter() - t
        current_step = jax.device_get(training_state.env_steps).to_int()
        sps = num_training_steps_per_epoch * env_step_per_training_step / epoch_time

        metrics = {
            "training/sps": sps,
            "training/walltime": epoch_time,
            **{f"training/{k}": float(v) for k, v in train_metrics.items()},
        }
        if num_evals > 1 or _ == num_evals_after_init - 1:
            metrics.update(
                evaluator.run_evaluation(
                    (training_state.normalizer_params, training_state.params.policy)
                )
            )
        all_metrics = metrics
        progress_fn(current_step, metrics)
        policy_params_fn(current_step, make_policy, _callback_params(training_state))
        # only one writer: concurrent saves into a shared directory from
        # every process race/corrupt
        if checkpoint_dir is not None and jax.process_index() == 0:
            import os as _os

            from puppax.train import checkpoint as ckpt_lib

            ckpt_path = ckpt_lib.save_checkpoint(
                current_step,
                jax.device_get(training_state),
                _os.path.join(str(checkpoint_dir), "state"),
            )
            if metrics_logger is not None:
                # reference utils.py:204-211: every checkpoint save is
                # followed by an artifact-store upload (wandb.log_model);
                # the pluggable sink records a pointer line on JSONL runs
                metrics_logger.log_artifact(
                    ckpt_path, name=f"checkpoint_state_{current_step}"
                )

    params = (training_state.normalizer_params, training_state.params)
    return make_policy, params, all_metrics
