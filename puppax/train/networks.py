"""Policy/value MLP networks and inference-fn factory (plain JAX).

Re-implementation of the PPO network stack the reference trained with
(brax make_ppo_networks / make_inference_fn — SURVEY §2.2).
Param-tree layout is part of the deployment ABI: policy params are a
dict ``{"params": {"hidden_0": {"kernel", "bias"}, ...}}`` whose final
layer emits 2*action_size (loc, scale) logits — exactly what
``export.convert_params`` consumes (/root/reference/pupperv3_mjx/
export.py:30-41) — and the policy factory signature
``make_policy((normalizer, policy_params), deterministic=...)`` matches
the reference's callback usage (utils.py:242).

MLPs here are tiny (obs ~540 -> a few hundred wide); per-device batches of
thousands of envs turn each layer into one (B, in) @ (in, out) matmul,
which XLA hands to cuBLAS — no custom kernels needed for the policy.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
from puppax import struct

from puppax.train import running_statistics
from puppax.train.distribution import NormalTanhDistribution

ActivationFn = Callable[[jnp.ndarray], jnp.ndarray]
Params = Any


@struct.dataclass
class PPONetworkParams:
    """Policy+value param bundle; ``.policy`` access is part of the
    reference callback surface (utils.py:242 ``params[1].policy``)."""

    policy: Params
    value: Params


class MLP:
    """Plain MLP with brax-compatible parameter naming: ``init(key, x)``
    returns ``{"params": {"hidden_i": {"kernel": (in, out), "bias": (out,)}}}``
    with lecun-uniform kernels and zero biases; ``apply(params, x)``."""

    def __init__(
        self,
        layer_sizes: Sequence[int],
        activation: ActivationFn = jax.nn.swish,
        activate_final: bool = False,
        kernel_init: Callable = jax.nn.initializers.lecun_uniform(),
        precision: Any = jax.lax.Precision.HIGHEST,
    ):
        self.layer_sizes = tuple(layer_sizes)
        self.activation = activation
        self.activate_final = activate_final
        self.kernel_init = kernel_init
        self.precision = precision

    def init(self, key: jax.Array, x: jnp.ndarray) -> Params:
        params = {}
        fan_in = x.shape[-1]
        keys = jax.random.split(key, len(self.layer_sizes))
        for i, size in enumerate(self.layer_sizes):
            params[f"hidden_{i}"] = {
                "kernel": self.kernel_init(keys[i], (fan_in, size), jnp.float32),
                "bias": jnp.zeros((size,), jnp.float32),
            }
            fan_in = size
        return {"params": params}

    def apply(self, params: Params, x: jnp.ndarray) -> jnp.ndarray:
        layers = params["params"]
        for i in range(len(self.layer_sizes)):
            layer = layers[f"hidden_{i}"]
            # HIGHEST (default): full-f32 products, never TF32. The policy
            # must compute identically in training and in the C++
            # deployment runtime (f64 replay, export/params.py). The VALUE network
            # has no such counterpart, so its precision is a tunable (see
            # make_ppo_networks value_precision).
            x = jnp.dot(x, layer["kernel"], precision=self.precision) + layer["bias"]
            if i != len(self.layer_sizes) - 1 or self.activate_final:
                x = self.activation(x)
        return x


@struct.dataclass
class FeedForwardNetwork:
    init: Callable = struct.field(pytree_node=False)
    apply: Callable = struct.field(pytree_node=False)


@struct.dataclass
class PPONetworks:
    policy_network: FeedForwardNetwork = struct.field(pytree_node=False)
    value_network: FeedForwardNetwork = struct.field(pytree_node=False)
    action_distribution: NormalTanhDistribution = struct.field(pytree_node=False)


def _make_network(
    module: MLP,
    obs_size: int,
    normalizer_aware: bool = True,
) -> FeedForwardNetwork:
    def init(key):
        return module.init(key, jnp.zeros((1, obs_size)))

    def apply(normalizer_state, params, obs):
        if normalizer_aware and normalizer_state is not None:
            obs = running_statistics.normalize(obs, normalizer_state)
        return module.apply(params, obs)

    return FeedForwardNetwork(init=init, apply=apply)


def make_ppo_networks(
    observation_size: int,
    action_size: int,
    policy_hidden_layer_sizes: Sequence[int] = (32, 32, 32, 32),
    value_hidden_layer_sizes: Sequence[int] = (256, 256, 256, 256, 256),
    activation: ActivationFn = jax.nn.swish,
    privileged_size: int = 0,
    value_precision: str = "highest",
) -> PPONetworks:
    """Build policy (obs -> 2*action logits) and value (obs -> scalar).

    ``privileged_size`` > 0 widens the VALUE network input to
    observation_size + privileged_size (asymmetric actor-critic: the
    critic sees ground-truth state the deployed policy cannot); the
    policy network and the export ABI are untouched.
    """
    dist = NormalTanhDistribution(event_size=action_size)
    policy_module = MLP(
        layer_sizes=tuple(policy_hidden_layer_sizes) + (dist.param_size,),
        activation=activation,
    )
    prec_map = {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }
    value_module = MLP(
        layer_sizes=tuple(value_hidden_layer_sizes) + (1,),
        activation=activation,
        precision=prec_map[value_precision],
    )
    policy_network = _make_network(policy_module, observation_size)

    value_apply_module = _make_network(
        value_module, observation_size + privileged_size
    )

    def value_apply(normalizer_state, params, obs):
        return jnp.squeeze(
            value_apply_module.apply(normalizer_state, params, obs), axis=-1
        )

    value_network = FeedForwardNetwork(
        init=value_apply_module.init, apply=value_apply
    )
    return PPONetworks(
        policy_network=policy_network,
        value_network=value_network,
        action_distribution=dist,
    )


def make_inference_fn(ppo_networks: PPONetworks):
    """Return ``make_policy(params, deterministic=False)`` where params is
    ``(normalizer_state, policy_params)`` — the reference's policy-factory
    contract (utils.py:242, export ABI)."""

    def make_policy(params: Tuple, deterministic: bool = False):
        normalizer_state, policy_params = params
        dist = ppo_networks.action_distribution

        def policy(obs: jnp.ndarray, rng: jax.Array):
            logits = ppo_networks.policy_network.apply(
                normalizer_state, policy_params, obs
            )
            if deterministic:
                return dist.mode(logits), {}
            pre_tanh = dist.sample_no_postprocessing(logits, rng)
            log_prob = dist.log_prob(logits, pre_tanh)
            return dist.postprocess(pre_tanh), {
                "log_prob": log_prob,
                "raw_action": pre_tanh,
            }

        return policy

    return make_policy
