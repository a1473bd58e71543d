#!/usr/bin/env python
"""Regenerate the committed compiled-model snapshots (needs ``mujoco``).

Writes ``puppax/model/snapshots/<xml_key>.npz`` for every model in
``VARIANTS`` and removes snapshots of XML that no variant produces any
more. ``mjcf.load_model`` reads these where mujoco is not installed.

Usage:
  python scripts/make_model_snapshots.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bundled_xml() -> str:
    from puppax.model import assets

    return assets.pupper_xml()


# name -> XML builder. The bundled flat Pupper v3 is the model the default
# training recipe and chip_smoke.py run.
VARIANTS = {"pupper_v3": bundled_xml}


def main():
    import mujoco

    from puppax.model import snapshot

    keep = set()
    for name, build in VARIANTS.items():
        xml = build()
        path = snapshot.save(mujoco.MjModel.from_xml_string(xml), xml)
        keep.add(os.path.basename(path))
        print(f"{name}: {path}")
    for f in os.listdir(snapshot.SNAPSHOT_DIR):
        if f.endswith(".npz") and f not in keep:
            os.remove(os.path.join(snapshot.SNAPSHOT_DIR, f))
            print(f"removed stale {f}")


if __name__ == "__main__":
    main()
