#!/usr/bin/env python
"""Export a trained checkpoint to the on-robot JSON policy.

The deployment path of the reference (download checkpoint -> restore ->
export.convert_params -> JSON for the C++ controller, SURVEY §3.5), as a
CLI: reads an export-style param checkpoint (``<ckpt>/<step>/`` layout,
as written by scripts/train.py), folds in normalization, and writes the
JSON dict the robot runtime consumes.

Usage:
  python scripts/export_policy.py --checkpoint /path/ckpt [--step N] \
      --out policy.json [--activation elu] [--action-scale 0.75] ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", required=True, help="checkpoint dir")
    parser.add_argument("--step", type=int, default=None, help="step (default latest)")
    parser.add_argument("--out", required=True, help="output JSON path")
    parser.add_argument("--activation", default="elu")
    parser.add_argument("--action-scale", type=float, default=0.75)
    parser.add_argument("--kp", type=float, default=5.0)
    parser.add_argument("--kd", type=float, default=0.25)
    parser.add_argument("--observation-history", type=int, default=2)
    parser.add_argument("--maximum-pitch-command", type=float, default=0.0)
    parser.add_argument("--maximum-roll-command", type=float, default=0.0)
    parser.add_argument("--no-imu", action="store_true")
    parser.add_argument(
        "--gait-phase-observation", action="store_true",
        help="policy was trained with the (cos, sin) gait clock appended "
        "to the obs; the exported JSON tells the on-robot runtime to "
        "append and advance the clock",
    )
    parser.add_argument("--gait-frequency", type=float, default=2.5)
    parser.add_argument("--control-dt", type=float, default=0.02)
    parser.add_argument(
        "--platform",
        default="cpu",
        help="jax platform (default cpu: export is host-side math and "
        "needs no accelerator)",
    )
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    from puppax.configs import get_config
    from puppax.env import PupperV3Env
    from puppax.export import convert_params
    from puppax.train import checkpoint

    restored = checkpoint.restore_checkpoint(args.checkpoint, step=args.step)
    # checkpoint layout: (normalizer_state_dict, {'policy':..., 'value':...})
    normalizer, net_params = restored

    class _Norm:
        """Attribute view over the restored normalizer dict."""

        def __init__(self, d):
            self.mean = np.asarray(d["mean"])
            self.std = np.asarray(d["std"])

    norm = _Norm(normalizer) if isinstance(normalizer, dict) else normalizer
    policy_params = (
        net_params["policy"] if isinstance(net_params, dict) else net_params.policy
    )

    env = PupperV3Env(
        path=None,
        reward_config=get_config(),
        action_scale=args.action_scale,
        observation_history=args.observation_history,
    )
    # the gait flag must match how the policy was trained: the clock adds
    # 2 obs dims, so the checkpoint's normalizer width is the ground truth
    # (exporting with the wrong flag would silently misalign the runtime's
    # clock features against real observation dims)
    expected = env.observation_size + (2 if args.gait_phase_observation else 0)
    got = int(np.asarray(norm.mean).size)
    if got != expected:
        hint = (
            "trained WITH the gait clock: pass --gait-phase-observation"
            if got == env.observation_size + 2
            else "trained WITHOUT the gait clock: drop --gait-phase-observation"
            if got == env.observation_size
            else "check --observation-history"
        )
        raise SystemExit(
            f"checkpoint obs width {got} != expected {expected} ({hint})"
        )
    exported = convert_params(
        (norm, policy_params),
        activation=args.activation,
        action_scale=args.action_scale,
        kp=args.kp,
        kd=args.kd,
        default_pose=np.asarray(env._default_pose),
        joint_upper_limits=np.asarray(env.uppers),
        joint_lower_limits=np.asarray(env.lowers),
        use_imu=not args.no_imu,
        observation_history=args.observation_history,
        maximum_pitch_command=args.maximum_pitch_command,
        maximum_roll_command=args.maximum_roll_command,
        gait_phase_observation=args.gait_phase_observation,
        gait_frequency=args.gait_frequency,
        control_dt=args.control_dt,
    )
    with open(args.out, "w") as f:
        json.dump(exported, f)
    n_params = sum(
        len(layer["weights"][1]) * (len(layer["weights"][0]) + 1)
        for layer in exported["layers"]
    )
    print(f"wrote {args.out}: {len(exported['layers'])} layers, ~{n_params} params, "
          f"in_shape={exported['in_shape']}")


if __name__ == "__main__":
    main()
