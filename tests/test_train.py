"""PPO learner tests: GAE math, networks/distribution, and an end-to-end
training smoke run on the virtual 8-device CPU mesh (the multi-chip
sharding path the driver dry-runs; SURVEY §4 'gaps to fill')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from puppax.configs import get_config
from puppax.env import PupperV3Env, domain_randomization
from puppax.train import make_inference_fn, make_ppo_networks, ppo
from puppax.train.distribution import NormalTanhDistribution
from puppax.train import running_statistics


def test_step_count_survives_int32_overflow():
    """env_steps must count past 2**31 without x64 (VERDICT r1 weakness 3)."""
    inc = 81920  # a typical env_step_per_training_step
    n = (2**31 // inc) + 7  # enough adds to blow through int32

    def body(sc, _):
        return sc.add(inc), ()

    sc, _ = jax.lax.scan(body, ppo.StepCount.zero(), (), length=n)
    total = jax.device_get(sc).to_int()
    assert total == n * inc
    assert total > 2**31  # would have wrapped negative as int32


def test_gae_constant_reward_no_done():
    """With r=1, V=0, no termination: advantage_t = sum of discounted
    lambda-weighted deltas; final step bootstrap 0."""
    T, B = 4, 2
    rewards = jnp.ones((T, B))
    values = jnp.zeros((T, B))
    zeros = jnp.zeros((T, B))
    vs, adv = ppo.compute_gae(
        truncation=zeros,
        termination=zeros,
        rewards=rewards,
        values=values,
        bootstrap_value=jnp.zeros(B),
        lambda_=1.0,
        discount=1.0,
    )
    # lambda=1, gamma=1: vs_t = sum_{s>=t} r_s = T - t
    np.testing.assert_allclose(vs[:, 0], jnp.array([4.0, 3.0, 2.0, 1.0]), rtol=1e-6)
    np.testing.assert_allclose(adv, vs, rtol=1e-6)


def test_gae_truncation_masks_delta():
    """A truncated step contributes no TD error and stops accumulation."""
    T, B = 3, 1
    rewards = jnp.ones((T, B))
    values = jnp.zeros((T, B))
    truncation = jnp.zeros((T, B)).at[1, 0].set(1.0)
    vs, adv = ppo.compute_gae(
        truncation=truncation,
        termination=jnp.zeros((T, B)),
        rewards=rewards,
        values=values,
        bootstrap_value=jnp.zeros(1),
        lambda_=1.0,
        discount=1.0,
    )
    assert float(adv[1, 0]) == 0.0  # masked
    assert float(adv[0, 0]) == 1.0  # no leak through the truncation


def test_distribution_log_prob_matches_numeric():
    dist = NormalTanhDistribution(event_size=3)
    rng = jax.random.PRNGKey(1)
    logits = jax.random.normal(rng, (5, 6))
    pre = dist.sample_no_postprocessing(logits, jax.random.PRNGKey(2))
    lp = dist.log_prob(logits, pre)
    assert lp.shape == (5,)
    assert bool(jnp.all(jnp.isfinite(lp)))
    # mode is tanh(loc)
    loc = logits[..., :3]
    np.testing.assert_allclose(dist.mode(logits), jnp.tanh(loc), rtol=1e-6)


def test_running_statistics_exact():
    state = running_statistics.init_state(3)
    rng = jax.random.PRNGKey(0)
    data1 = jax.random.normal(rng, (100, 3)) * 2.0 + 1.0
    data2 = jax.random.normal(jax.random.PRNGKey(1), (50, 3)) * 0.5
    state = running_statistics.update(state, data1)
    state = running_statistics.update(state, data2)
    all_data = jnp.concatenate([data1, data2])
    np.testing.assert_allclose(state.mean, all_data.mean(0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(state.std, all_data.std(0), rtol=1e-4, atol=1e-5)


def test_networks_param_layout_matches_export_abi():
    """Policy params must be {'params': {'hidden_i': {kernel, bias}}} with a
    final 2*action_size head — the export ABI (reference export.py:30-41)."""
    net = make_ppo_networks(10, 4, policy_hidden_layer_sizes=(16, 16))
    params = net.policy_network.init(jax.random.PRNGKey(0))
    layers = params["params"]
    assert list(layers.keys()) == ["hidden_0", "hidden_1", "hidden_2"]
    assert layers["hidden_2"]["bias"].shape == (8,)  # loc + scale
    # inference fn contract: params = (normalizer, policy_params)
    make_policy = make_inference_fn(net)
    norm = running_statistics.init_state(10)
    policy = make_policy((norm, params))
    act, extras = policy(jnp.zeros((3, 10)), jax.random.PRNGKey(0))
    assert act.shape == (3, 4)
    assert bool(jnp.all(jnp.abs(act) <= 1.0))
    assert "log_prob" in extras and "raw_action" in extras


def test_mlp_params_and_apply():
    """networks.MLP: {'params': {'hidden_i': {kernel (in, out), bias}}},
    lecun-uniform kernels, zero biases, and apply == the dense layers
    computed in float64 numpy."""
    from puppax.train.networks import MLP

    mlp = MLP(layer_sizes=(16, 8, 3), activation=jax.nn.elu)
    params = mlp.init(jax.random.PRNGKey(1), jnp.zeros((1, 5)))
    layers = params["params"]
    assert list(layers) == ["hidden_0", "hidden_1", "hidden_2"]
    fan_in = 5
    for i, size in enumerate((16, 8, 3)):
        k, b = layers[f"hidden_{i}"]["kernel"], layers[f"hidden_{i}"]["bias"]
        assert k.shape == (fan_in, size) and k.dtype == jnp.float32
        assert b.shape == (size,) and not np.any(np.asarray(b))
        # lecun uniform: U(-sqrt(3/fan_in), sqrt(3/fan_in))
        assert np.abs(np.asarray(k)).max() <= np.sqrt(3.0 / fan_in) + 1e-6
        fan_in = size
    x = np.random.RandomState(0).normal(size=(7, 5))
    ref = x
    for i in range(3):
        ref = ref @ np.asarray(layers[f"hidden_{i}"]["kernel"], np.float64)
        if i < 2:
            ref = np.where(ref > 0, ref, np.expm1(ref))
    got = mlp.apply(params, jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-5)
    # distinct keys give distinct initializations
    other = mlp.init(jax.random.PRNGKey(2), jnp.zeros((1, 5)))
    assert not np.allclose(
        np.asarray(other["params"]["hidden_0"]["kernel"]),
        np.asarray(layers["hidden_0"]["kernel"]),
    )


@pytest.mark.slow
def test_ppo_train_smoke_multidevice():
    """End-to-end PPO on the real env over the virtual 8-device CPU mesh:
    2 epochs, tiny batches; asserts progress/callback plumbing + finite
    losses + reward metrics flow."""
    env = PupperV3Env(
        path=None,
        reward_config=get_config(),
        action_scale=0.75,
        observation_history=2,
        maximum_pitch_command=10.0,
        maximum_roll_command=10.0,
        resample_velocity_step=50,
    )
    progress_steps = []

    def progress(step, metrics):
        progress_steps.append((step, metrics))

    make_policy, params, metrics = ppo.train(
        env,
        num_timesteps=2 * 8 * 16 * 2 * 2,  # 2 epochs worth
        episode_length=32,
        num_envs=16,
        num_eval_envs=8,
        unroll_length=8,
        batch_size=8,
        num_minibatches=2,
        num_updates_per_batch=1,
        num_evals=3,
        seed=0,
        randomization_fn=domain_randomization.domain_randomize,
        progress_fn=progress,
        # schedule plumbing rides along in the smoke (lr decays over the
        # run; entropy cost anneals linearly with env-step progress)
        lr_schedule="cosine",
        lr_final_fraction=0.1,
        entropy_schedule="linear",
        entropy_cost_final=2e-3,
    )
    assert "eval/episode_reward" in metrics
    assert np.isfinite(metrics["eval/episode_reward"])
    assert any("training/total_loss" in m for _, m in progress_steps)
    for _, m in progress_steps:
        for k, v in m.items():
            assert np.isfinite(v), (k, v)
    # returned params follow the reference contract
    normalizer, net_params = params
    policy = make_policy((normalizer, net_params.policy), deterministic=True)
    act, _ = policy(jnp.zeros(env.observation_size), jax.random.PRNGKey(0))
    assert act.shape == (12,)


@pytest.mark.slow
def test_ppo_checkpoint_resume(tmp_path):
    """Full train-state checkpointing + resume: a resumed run restores the
    exact params saved at the last eval epoch (SURVEY §5 checkpoint gap)."""
    import functools

    from puppax.train import make_ppo_networks

    env = PupperV3Env(
        path=None,
        reward_config=get_config(),
        action_scale=0.75,
        observation_history=1,
    )
    net_factory = functools.partial(
        make_ppo_networks,
        policy_hidden_layer_sizes=(8,),
        value_hidden_layer_sizes=(8,),
    )
    kwargs = dict(
        episode_length=8,
        num_envs=8,
        num_eval_envs=8,
        unroll_length=4,
        batch_size=4,
        num_minibatches=2,
        num_updates_per_batch=1,
        num_evals=2,
        seed=1,
        network_factory=net_factory,
        checkpoint_dir=str(tmp_path / "ckpt"),
    )
    steps_per = 4 * 4 * 2  # batch*unroll*minibatches
    _, params1, _ = ppo.train(env, num_timesteps=steps_per, **kwargs)

    # resume with the same target: restores and stops without training
    _, params2, _ = ppo.train(
        env, num_timesteps=steps_per, resume=True, **kwargs
    )
    for a, b in zip(
        jax.tree_util.tree_leaves(params1[1]), jax.tree_util.tree_leaves(params2[1])
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


@pytest.mark.slow
def test_lazy_shuffle_bit_parity():
    """train(lazy_shuffle=True) follows the EXACT same training
    trajectory as the eager global shuffle: same permutation key stream,
    same minibatch rows in the same order, only the gather is deferred
    into the update scan (ppo.py sgd_step). Final params must match the
    eager path bit-for-bit — the knob is a pure layout/throughput lever
    (VERDICT r4 item 2: learner-overhead levers)."""
    env = PupperV3Env(
        path=None,
        reward_config=get_config(),
        action_scale=0.75,
        observation_history=2,
    )
    kwargs = dict(
        episode_length=16,
        num_envs=8,
        num_eval_envs=8,
        unroll_length=4,
        batch_size=4,
        num_minibatches=2,
        num_updates_per_batch=2,
        num_evals=1,
        seed=3,
    )
    steps = 2 * 4 * 4 * 2  # 2 training steps worth
    _, params_eager, _ = ppo.train(
        env, num_timesteps=steps, lazy_shuffle=False, **kwargs
    )
    _, params_lazy, _ = ppo.train(
        env, num_timesteps=steps, lazy_shuffle=True, **kwargs
    )
    eager_leaves = jax.tree_util.tree_leaves(params_eager)
    lazy_leaves = jax.tree_util.tree_leaves(params_lazy)
    assert len(eager_leaves) == len(lazy_leaves)
    for a, b in zip(eager_leaves, lazy_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
