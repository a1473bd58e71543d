"""Model asset handling.

The Pupper v3 test robot description (body tree, inertials, collision
spheres, actuators, solver options — see SURVEY §1 L1) is consumed from an
MJCF file. The visual STL meshes are render-only (contype=0, density=0,
/root/reference/test/test_pupper_model.xml:47,89), so for physics, training
and CI we derive a mesh-free physics-equivalent XML: identical numeric
model (nq/nv/nu, masses, inertials, collision spheres, options), no mesh
assets. Rendering paths can still load the original mesh-bearing XML when
available.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

BUNDLED_XML = os.path.join(os.path.dirname(__file__), "pupper_v3.xml")
# the mesh-bearing reference MJCF (a pupperv3-mjx checkout's
# test/test_pupper_model.xml) when PUPPAX_REFERENCE_XML names one; the
# bundled mesh-free copy otherwise
REFERENCE_XML = os.environ.get("PUPPAX_REFERENCE_XML", BUNDLED_XML)


def strip_meshes(tree: ET.ElementTree) -> ET.ElementTree:
    """Remove mesh assets and mesh geoms from a model tree (visual-only)."""
    root = tree.getroot()
    for asset in root.findall("asset"):
        for mesh in asset.findall("mesh"):
            asset.remove(mesh)
    # drop geoms that reference meshes anywhere in the body tree
    parents = {child: parent for parent in root.iter() for child in parent}
    for geom in list(root.iter("geom")):
        if geom.get("mesh") is not None:
            parents[geom].remove(geom)
    compiler = root.find("compiler")
    if compiler is not None and "meshdir" in compiler.attrib:
        del compiler.attrib["meshdir"]
    return tree


def pupper_xml_tree() -> ET.ElementTree:
    """ElementTree of the physics-equivalent (mesh-free) Pupper v3 model."""
    if os.path.exists(BUNDLED_XML):
        return ET.parse(BUNDLED_XML)
    tree = ET.parse(REFERENCE_XML)
    return strip_meshes(tree)


def pupper_xml() -> str:
    """XML string of the physics-equivalent Pupper v3 model."""
    return ET.tostring(pupper_xml_tree().getroot(), encoding="unicode")


def write_bundled_asset() -> str:
    """Materialize the mesh-free model into the package (build-time helper)."""
    tree = ET.parse(REFERENCE_XML)
    strip_meshes(tree)
    tree.write(BUNDLED_XML, encoding="unicode")
    return BUNDLED_XML
