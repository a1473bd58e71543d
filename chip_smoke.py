#!/usr/bin/env python
"""Smoke test of puppax on NVIDIA GPUs: the batched env step and PPO training.

One process. Phases, in order, each printing its compile and run seconds:

1. device: the backend must be ``gpu``; prints the card's name and power
   limit as ``nvidia-smi`` reports them.
2. env step vs the plain reference, 4096 envs with domain randomization
   (DR). The GPU runs the batched step on the per-env XLA engine
   (``backend.step_path``); the reference is the same step compiled for
   the host CPU. float32 throughout; the physics runs under matmul
   precision ``highest``, so no product uses TF32.

   * One step from reset: every env within the per-field tolerance
     ``ATOL[field] + RTOL * |cpu|``.
   * Control: the same check must reject a step whose input state was
     rounded to TF32's 10-bit mantissa, which shows the tolerance is tight
     enough to see reduced-precision arithmetic.
   * Steps 2..20, each from the GPU's own state: contact dynamics are
     discontinuous there (pair caps, the line search's active segment), so
     a last-bit difference can move an env's step by more than rounding.
     The reference shows this itself: its step from an input perturbed by
     2^-22 (relative) leaves the tolerance in a similar number of envs.
     The GPU may leave it in at most twice as many env-steps as the
     perturbed reference does, plus ``SLACK``.
3. ``scripts/train.py`` (``ppo.train``) at the default recipe for 3
   training steps and 2 evals: the rollout on the GPU's step path, finite
   loss and eval reward, trained state on the GPU. Prints steps/s beside
   the card's name and power limit as information.

With ``--four`` it runs only the four-card path instead: ``ppo.train`` on
four cards at 4096 envs per card, and 20 steps of 4096 envs sharded over
the four cards against the same steps on one card, env by env.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failed phase exits non-zero before that line.

Usage:
  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PLATFORM = "gpu"
N_ENVS = 4096
N_STEPS = 20

# Per-field tolerance |gpu - cpu| <= ATOL[field] + RTOL * |cpu|. ATOL is
# about 10x the largest error an H100 showed at RTOL after one step from
# reset (qpos 3.6e-7, qvel 1.6e-4, obs 1.5e-5, reward 6.4e-8): GPU and CPU
# run the same XLA program, but XLA:GPU contracts mul+add into fused
# multiply-adds, orders reductions differently and has its own sin/cos/exp,
# and those last bits pass through 5 substeps of the Newton solve.
RTOL = 1e-5
ATOL = {"qpos": 4e-6, "qvel": 2e-3, "obs": 2e-4, "reward": 1e-6}
FIELDS = tuple(ATOL)
# relative size of the reference's own input perturbation (2 ulp of f32)
PERTURB = 2.0 ** -22
# env-steps outside tolerance allowed beyond twice the perturbed reference's
SLACK = 10


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def fields(state) -> dict:
    return {
        "qpos": state.pipeline_state.qpos,
        "qvel": state.pipeline_state.qvel,
        "obs": state.obs,
        "reward": state.reward,
    }


def env_errors(got: dict, ref: dict):
    """Per env, the largest ``|got - ref| / (ATOL[f] + RTOL * |ref|)`` over
    every field and element (> 1: outside tolerance), and per field the
    largest absolute error. Arrays are (env, ...)."""
    import numpy as np

    worst, abs_err = None, {}
    for name in FIELDS:
        a = np.asarray(got[name], np.float64)
        b = np.asarray(ref[name], np.float64)
        if a.shape != b.shape:
            raise PhaseError(f"{name}: shape {a.shape} != {b.shape}")
        if not np.isfinite(a).all():
            raise PhaseError(f"{name}: non-finite values")
        err = np.abs(a - b).reshape(a.shape[0], -1)
        abs_err[name] = float(err.max())
        ratio = (err / (ATOL[name] + RTOL * np.abs(b).reshape(err.shape))).max(axis=1)
        worst = ratio if worst is None else np.maximum(worst, ratio)
    return worst, abs_err


def check_close(tag: str, got: dict, ref: dict) -> str:
    """Every env within tolerance, or PhaseError."""
    worst, abs_err = env_errors(got, ref)
    summary = (
        f"{tag}: max abs err "
        + ", ".join(f"{n} {abs_err[n]:.3e}" for n in FIELDS)
        + f"; worst env at {worst.max():.3f} of its tolerance"
    )
    bad = int((worst > 1).sum())
    if bad:
        raise PhaseError(f"{summary}; {bad} of {len(worst)} envs outside tolerance")
    return summary


def check_rejects(tag: str, got: dict, ref: dict) -> str:
    """The negative control: most envs must fall outside tolerance."""
    worst, _ = env_errors(got, ref)
    bad = int((worst > 1).sum())
    summary = f"{tag}: {bad} of {len(worst)} envs outside tolerance"
    if bad < len(worst) // 2:
        raise PhaseError(f"{summary}: the tolerance is too loose to see it")
    return summary


def check_like_reference(n_gpu: int, n_ref: int, n_total: int) -> str:
    """Mid-trajectory rule: env-steps outside tolerance on the GPU are at
    most twice the perturbed reference's, plus SLACK."""
    limit = 2 * n_ref + SLACK
    summary = (
        f"{n_gpu} of {n_total} env-steps outside tolerance on the gpu, "
        f"{n_ref} for the reference perturbed by {PERTURB:.1e} (limit {limit})"
    )
    if n_gpu > limit:
        raise PhaseError(summary)
    return summary


def round_to_tf32(x):
    """``x`` with its mantissa rounded to TF32's 10 bits."""
    import jax

    return jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=10)


def timed(fn, *args, jit_kw=None):
    """(compile seconds, first-run seconds, compiled fn, result) of
    ``jax.jit(fn, **jit_kw)`` at ``args``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn, **(jit_kw or {})).lower(*args).compile()
    t1 = time.perf_counter()
    out = compiled(*args)
    jax.block_until_ready(out)
    return t1 - t0, time.perf_counter() - t1, compiled, out


def phase_device(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != PLATFORM:
        raise PhaseError(f"no GPU: JAX's backend is {devs[0].platform!r}")
    if len(devs) < count:
        raise PhaseError(f"{count} GPUs needed, {len(devs)} found")
    log(f"[device] {card_line()}")
    log(f"[device] jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs


def _dr_env(num_envs: int, seed: int = 0):
    import jax

    from puppax.configs import get_config
    from puppax.env import PupperV3Env, domain_randomization, wrappers

    env = PupperV3Env(
        path=None, reward_config=get_config(), action_scale=0.75,
        observation_history=2,
    )
    wrapped = wrappers.wrap_for_training(
        env, episode_length=1000,
        randomization_fn=domain_randomization.domain_randomize,
        randomization_rng=jax.random.split(jax.random.PRNGKey(seed), num_envs),
    )
    return env, wrapped


def _cpu_reference(num_envs: int):
    """The same DR env with every array on the host CPU: its jitted step
    compiles for the CPU."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _, wrapped = _dr_env(num_envs)
    step = jax.jit(wrapped.step)

    def uncached_first_call(*args):
        # a host-CPU executable from the persistent cache may have been
        # compiled on another host with other CPU features
        jax.config.update("jax_enable_compilation_cache", False)
        try:
            return step(*args)
        finally:
            jax.config.update("jax_enable_compilation_cache", True)

    return step, uncached_first_call, cpu


def _with_qpos_qvel(state, f_qpos, f_qvel):
    ps = state.pipeline_state
    return state.replace(
        pipeline_state=ps.replace(qpos=f_qpos(ps.qpos), qvel=f_qvel(ps.qvel))
    )


def phase_step():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from puppax import backend

    env, wrapped = _dr_env(N_ENVS)
    log(f"[step] batched step path on gpu: {backend.step_path()}")
    t0 = time.perf_counter()
    state = jax.jit(wrapped.reset)(jax.random.split(jax.random.PRNGKey(1), N_ENVS))
    jax.block_until_ready(state)
    log(f"[step] reset {N_ENVS} envs: {time.perf_counter() - t0:.1f} s (compile included)")
    acts = jnp.tanh(
        jax.random.normal(jax.random.PRNGKey(2), (N_STEPS, N_ENVS, env.action_size))
    )
    cpu_step, cpu_first_call, cpu = _cpu_reference(N_ENVS)

    c, r, gpu_c, s_gpu = timed(wrapped.step, state, acts[0])
    log(f"[step] gpu step: compile {c:.1f} s, first run {r:.3f} s")
    t0 = time.perf_counter()
    s_cpu = cpu_first_call(jax.device_put(state, cpu), jax.device_put(acts[0], cpu))
    jax.block_until_ready(s_cpu)
    log(f"[step] cpu reference step: compile+run {time.perf_counter() - t0:.1f} s")
    log(f"[step] tolerance |gpu - cpu| <= ATOL + {RTOL:g}*|cpu|, ATOL "
        + ", ".join(f"{n} {a:g}" for n, a in ATOL.items()))

    log("[step] " + check_close("gpu vs cpu, 1 step from reset", fields(s_gpu), fields(s_cpu)))
    if (flips := int((np.asarray(s_gpu.done) != np.asarray(s_cpu.done)).sum())):
        raise PhaseError(f"1 step from reset: done flags differ in {flips} envs")

    s_tf32 = gpu_c(_with_qpos_qvel(state, round_to_tf32, round_to_tf32), acts[0])
    log("[step] control, gpu step from a TF32-rounded state vs cpu: "
        + check_rejects("rejected", fields(s_tf32), fields(s_cpu)))

    rng = np.random.default_rng(0)
    n_gpu = n_ref = witnessed = 0
    free, cur, t_gpu = s_cpu, s_gpu, 0.0
    for t in range(1, N_STEPS):
        here = jax.device_put(cur, cpu)
        act = jax.device_put(acts[t], cpu)
        ref = cpu_step(here, act)
        signs = [
            rng.choice([-PERTURB, PERTURB], x.shape).astype(np.float32)
            for x in (here.pipeline_state.qpos, here.pipeline_state.qvel)
        ]
        nudged = cpu_step(_with_qpos_qvel(
            here, lambda q: q * (1 + signs[0]), lambda v: v * (1 + signs[1])
        ), act)
        t1 = time.perf_counter()
        nxt = gpu_c(cur, acts[t])
        jax.block_until_ready(nxt)
        t_gpu += time.perf_counter() - t1
        g, _ = env_errors(fields(nxt), fields(ref))
        p, _ = env_errors(fields(nudged), fields(ref))
        n_gpu += int((g > 1).sum())
        n_ref += int((p > 1).sum())
        witnessed += int(((g > 1) & (p > 1)).sum())
        free = cpu_step(free, act)
        cur = nxt
    log(f"[step] gpu vs cpu, steps 2..{N_STEPS} each from the gpu's state: "
        + check_like_reference(n_gpu, n_ref, N_ENVS * (N_STEPS - 1))
        + f"; {witnessed} of the gpu's also leave it under the perturbation")
    spread = []
    for n, a in fields(cur).items():
        err = np.abs(np.asarray(a) - np.asarray(fields(free)[n]))
        spread.append(f"{n} {np.median(err):.1e}/{err.max():.1e}")
    log(
        f"[step] gpu vs cpu after {N_STEPS} free-running steps, median/max abs "
        f"err: {', '.join(spread)}"
    )
    if not all(np.isfinite(np.asarray(x)).all() for x in fields(cur).values()):
        raise PhaseError(f"non-finite state after {N_STEPS} gpu steps")
    log(
        f"[step] gpu: {N_STEPS - 1} steps of {N_ENVS} envs, one dispatch each: "
        f"{t_gpu * 1e3 / (N_STEPS - 1):.3f} ms/step (host clock) -> "
        f"{N_ENVS * (N_STEPS - 1) / t_gpu:.0f} env-steps/s; card: {card_line()}"
    )


def _train_module():
    spec = importlib.util.spec_from_file_location(
        "puppax_train_script", os.path.join(HERE, "scripts", "train.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tee(io.StringIO):
    def __init__(self, out):
        super().__init__()
        self._out = out

    def write(self, text):
        self._out.write(text)
        return super().write(text)


def phase_train(num_envs: int, devices: int):
    """scripts/train.py at the default recipe, 3 training steps, 2 evals.
    Across several cards the batch per SGD step grows with the env count
    (each training step must take at least one unroll of every env)."""
    import jax
    import numpy as np

    from puppax.configs import experiment as exp

    t = exp.TrainConfig()
    batch_size = max(t.batch_size, num_envs // t.num_minibatches)
    per_step = batch_size * t.unroll_length * t.num_minibatches
    overrides = [
        f"train.num_timesteps={3 * per_step}",
        "train.num_evals=2",
        f"train.num_envs={num_envs}",
        f"train.batch_size={batch_size}",
    ]
    argv = [a for o in overrides for a in ("--set", o)]
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        params, metrics = _train_module().main(argv)
    wall = time.perf_counter() - t0
    text = tee.getvalue()
    banner = [ln for ln in text.splitlines() if "rollout step path:" in ln]
    expect = f"rollout step path: engine on '{PLATFORM}' (devices={devices})"
    if not banner or expect not in banner[-1]:
        raise PhaseError(f"expected {expect!r}, got {banner}")
    for k in ("training/policy_loss", "training/total_loss", "eval/episode_reward"):
        if k not in metrics or not np.isfinite(metrics[k]):
            raise PhaseError(f"{k} missing or not finite: {metrics.get(k)}")
    leaf_platforms = {
        d.platform for leaf in jax.tree_util.tree_leaves(params) for d in leaf.devices()
    }
    if leaf_platforms != {PLATFORM}:
        raise PhaseError(f"trained state not on the GPU: {leaf_platforms}")
    log(
        f"[train] {num_envs} envs on {devices} card(s), 3 training steps + 2 evals: "
        f"wall {wall:.1f} s (compile included); epoch {metrics['training/walltime']:.1f} s "
        f"(its compile included) -> {metrics['training/sps']:.0f} env-steps/s; "
        f"eval reward {metrics['eval/episode_reward']:.3f}; "
        f"loss {metrics['training/total_loss']:.4f}; card: {card_line()}"
    )


def phase_four_steps():
    """N_ENVS envs sharded over 4 cards vs the same envs on one card, for
    N_STEPS steps of the same actions. The one-card programs are those of
    phase_step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    env, wrapped = _dr_env(N_ENVS)
    acts = jnp.tanh(
        jax.random.normal(jax.random.PRNGKey(2), (N_STEPS, N_ENVS, env.action_size))
    )
    keys = jax.random.split(jax.random.PRNGKey(1), N_ENVS)
    mesh = Mesh(np.array(jax.devices()[:4]), ("env",))
    env_axis = NamedSharding(mesh, P("env"))
    one = jax.devices()[0]
    sharded = dict(in_shardings=(env_axis, env_axis), out_shardings=env_axis)
    runs = {}
    for tag, put, reset_kw, step_kw in (
        ("one card", lambda x: jax.device_put(x, one), {}, {}),
        ("four cards", lambda x: jax.device_put(x, env_axis),
         dict(out_shardings=env_axis), sharded),
    ):
        t0 = time.perf_counter()
        state = jax.jit(wrapped.reset, **reset_kw)(put(keys))
        jax.block_until_ready(state)
        tr = time.perf_counter() - t0
        c, r, step, state = timed(wrapped.step, state, put(acts[0]), jit_kw=step_kw)
        first = state
        t0 = time.perf_counter()
        for t in range(1, N_STEPS):
            state = step(state, put(acts[t]))
        jax.block_until_ready(state)
        log(f"[four] {tag}, {N_ENVS} envs: reset {tr:.1f} s (compile included), "
            f"step compile {c:.1f} s, {N_STEPS - 1} more steps {time.perf_counter() - t0:.3f} s")
        runs[tag] = (first, state)
    (f1, l1), (f4, l4) = runs["one card"], runs["four cards"]
    shards = {s.device for s in f4.pipeline_state.qpos.addressable_shards}
    if len(shards) != 4:
        raise PhaseError(f"sharded state lives on {len(shards)} cards, not 4")
    log("[four] " + check_close("sharded vs one card, step 1", fields(f4), fields(f1)))
    spread = []
    for n in FIELDS:
        a, b = np.asarray(fields(l4)[n]), np.asarray(fields(l1)[n])
        if not np.isfinite(a).all():
            raise PhaseError(f"sharded steps: non-finite {n}")
        err = np.abs(a - b)
        spread.append(f"{n} {np.median(err):.1e}/{err.max():.1e}")
    log(f"[four] sharded vs one card after {N_STEPS} steps, median/max abs err: "
        + ", ".join(spread))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-card path (needs 4 GPUs)",
    )
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "puppax")):
        print("chip_smoke.py: the puppax package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    import jax

    from puppax import compile_cache

    compile_cache.enable()
    count = 4 if args.four else 1
    try:
        t0 = time.perf_counter()
        devs = phase_device(count)
        log(f"[device] ok in {time.perf_counter() - t0:.1f} s")
        if args.four:
            phases = (
                ("train", lambda: phase_train(4 * N_ENVS, 4)),
                ("four", phase_four_steps),
            )
        else:
            phases = (
                ("step", phase_step),
                ("train", lambda: phase_train(N_ENVS, 1)),
            )
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    except PhaseError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
