"""Where the batched env step runs: one decision, made from the JAX backend.

``step_path`` answers for ``gpu`` and ``cpu`` with ``"engine"``: the
per-env XLA engine (physics/pipeline.py) vmapped over the env batch, the
oracle-checked reference. Any other platform raises.

A GPU step path faster than the engine, compile included, would be chosen
here; PERF.md ("Findings") records why the fused env-step emission was not.
"""

from __future__ import annotations

from typing import Optional

import jax

PLATFORMS = ("gpu", "cpu")


def step_path(platform: Optional[str] = None) -> str:
    """The batched step path for ``platform`` (default:
    ``jax.default_backend()``)."""
    platform = platform or jax.default_backend()
    if platform not in PLATFORMS:
        raise ValueError(
            f"puppax has no step path for platform {platform!r}: it runs on "
            "'gpu', and on 'cpu' for tests"
        )
    return "engine"
