"""Reward configuration: the 18 named scales + tracking sigma.

Values are the reference training defaults, verbatim
(/root/reference/pupperv3_mjx/config.py:19-64) — these are tuned
hyperparameters, i.e. data the framework must reproduce for parity.
Exposed as nested attribute dicts so downstream code can use the
reference's ``config.rewards.scales[k]`` / ``config.rewards.tracking_sigma``
access patterns.
"""


class AttrDict(dict):
    """A dict whose keys are also readable and writable as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


def get_config() -> AttrDict:
    """Reward config for the Pupper v3 joystick-locomotion task."""
    scales = AttrDict(
        dict(
            # tracking rewards: exp(-error^2 / tracking_sigma)
            tracking_lin_vel=1.5,
            tracking_ang_vel=0.8,
            # base state regularization
            lin_vel_z=-2.0,
            ang_vel_xy=-0.05,
            orientation=-5.0,
            tracking_orientation=1.0,
            # joint regularization
            torques=-0.0002,
            joint_acceleration=-1e-6,
            mechanical_work=-0.00,
            action_rate=-0.01,
            # gait shaping
            feet_air_time=0.2,
            stand_still=-0.5,
            stand_still_joint_velocity=-0.1,
            abduction_angle=-0.1,
            # safety
            termination=-100.0,
            foot_slip=-0.1,
            knee_collision=-1.0,
            body_collision=-1.0,
        )
    )
    rewards = AttrDict(scales=scales, tracking_sigma=0.25)
    return AttrDict(rewards=rewards)
