"""Stand-in meshes for the tet robots' reference meshes (diamond.vtu,
trunk.vtk), which the repository does not hold: box meshes written under
the file names the builders read, with the robots' fixed boxes and every
cable waypoint inside them. The boxes of the robots' widths (the card's)
hold every node index the campaign scripts name as a literal (the
Diamond's output node 1354 and measurement nodes up to 1445; the Trunk's
tip 51 and nodes 22 and 37); the small Diamond of the CPU tests cannot,
and `map_nodes` maps them onto it.

`standins(root, fems)` points each given sim/fem_tet module (either
package's) at the stand-ins: REFERENCE_MESH_DIR at the meshes and
PLANT_CACHE_DIR at a cache directory under `root`. The cache has to move
too: with mesh_path=None the builders cache a plant under the real
robot's key, so a box built through REFERENCE_MESH_DIR alone would be
saved as the Diamond, and a later run on the real mesh would load the box.
Both packages write the same npz layout under the same key, so modules
given one cache directory share one build.

`run_port(mod, argv)` runs a campaign twin's main and returns what its
gates said; `restore(moved)` copies a failed run's quarantined artifacts
back where the run wrote them.

Used by the CPU tests and by chip_smoke.py; JAX-free; importing it changes
nothing."""

import contextlib
import os

import numpy as np

# phase 23's box: make_box_mesh(11, 12, 12, spacing=10) minus the shift,
# 1,584 nodes in the Diamond's scene
DIAMOND_BOX = dict(shape=(11, 12, 12), scale=(10.0, 10.0, 10.0),
                   shift=(50.0, 35.0, 55.0))
# the Trunk's width: make_box_mesh(5, 5, 28, spacing=7) about the z axis,
# 700 nodes; x, y within +-14, z up to 189 (the cables' waypoints reach
# +-10.5 and 185)
TRUNK_BOX = dict(shape=(5, 5, 28), scale=(7.0, 7.0, 7.0),
                 shift=(14.0, 14.0, 0.0))
# a small Trunk for the CPU tests: 3 x 3 x 19 nodes, 24 apart in x and y
# and 10.5 in z, 171 nodes (a layer at z = 21, the cables' first free
# waypoint, just above the fixed base at z <= 20)
TRUNK_SMALL = dict(shape=(3, 3, 19), scale=(12.0, 12.0, 10.5),
                   shift=(12.0, 12.0, 0.0))

# the node indices the campaign scripts name as literals
DIAMOND_NODES = (1354, 726, 139, 1445, 729)
TRUNK_NODES = (51, 22, 37)
# a small Diamond for the CPU tests: 5 x 5 x 5 nodes in the Diamond's
# scene, 125 nodes, 9 of them fixed. It cannot hold the Diamond's node
# literals, so the tests map them (`map_nodes`) onto its top centre (the
# output) and four nodes on its sides.
DIAMOND_SMALL = dict(shape=(5, 5, 5), scale=(12.5, 27.5, 12.5),
                     shift=(25.0, 35.0, 25.0))
DIAMOND_SMALL_NODES = {1354: 72, 726: 112, 139: 12, 1445: 60, 729: 64}


def box(shape, scale, shift):
    """make_box_mesh(*shape, spacing=1) scaled per axis and shifted:
    (points, tets)."""
    from soft_robot_control_tpu_torch.sim.fem_tet import make_box_mesh

    pts, tets = make_box_mesh(*shape, spacing=1.0)
    return pts * np.asarray(scale) - np.asarray(shift), tets


def write_vtk_legacy(path, pts, tets):
    """An ASCII legacy .vtk of a tet mesh, the format of trunk.vtk."""
    lines = ["# vtk DataFile Version 2.0", "stand-in", "ASCII",
             "DATASET UNSTRUCTURED_GRID", f"POINTS {len(pts)} double"]
    lines += [" ".join(repr(float(c)) for c in p) for p in pts]
    lines.append(f"CELLS {len(tets)} {5 * len(tets)}")
    lines += ["4 " + " ".join(str(int(c)) for c in t) for t in tets]
    lines.append(f"CELL_TYPES {len(tets)}")
    lines += ["10"] * len(tets)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_standins(mesh_dir, diamond=DIAMOND_BOX, trunk=TRUNK_BOX):
    """diamond.vtu and trunk.vtk in mesh_dir; their node counts."""
    from soft_robot_control_tpu_torch.sim.fem_tet import write_vtu_ascii

    os.makedirs(mesh_dir, exist_ok=True)
    dp, dt_ = box(**diamond)
    write_vtu_ascii(os.path.join(mesh_dir, "diamond.vtu"), dp, dt_)
    tp, tt = box(**trunk)
    write_vtk_legacy(os.path.join(mesh_dir, "trunk.vtk"), tp, tt)
    return {"diamond": len(dp), "trunk": len(tp)}


def fits_the_scene(plant, nodes):
    """Phase 23's check of a built stand-in: (fixed nodes, each cable
    column's net force, ok): some nodes fixed, every column's net force 1,
    and every named node in the mesh."""
    to_np = (lambda a: a.detach().cpu().numpy()) if hasattr(
        plant.H, "detach") else np.asarray
    H = to_np(plant.H)
    n_fixed = int((to_np(plant.free_mask) == 0).sum()) // 3
    cols = np.linalg.norm(H.reshape(-1, 3, H.shape[1]).sum(0), axis=0)
    ok = (n_fixed > 0 and np.allclose(cols, 1.0)
          and plant.n_nodes > max(nodes))
    return n_fixed, cols, ok


def map_nodes(mp, robot_cls, mapping):
    """Through mp (a pytest MonkeyPatch), every node index the robot class
    names or is given mapped by `mapping`: its default output and
    measurement nodes and the nodes passed to its output and measurement
    models."""
    def m(nodes):
        return None if nodes is None else [mapping.get(n, n) for n in nodes]

    for attr in ("default_output_nodes", "default_measurement_nodes"):
        mp.setattr(robot_cls, attr, m(getattr(robot_cls, attr)))
    for meth in ("get_measurement_model", "get_output_model"):
        def wrapped(self, nodes=None, *a, _orig=getattr(robot_cls, meth),
                    **kw):
            return _orig(self, m(nodes), *a, **kw)
        mp.setattr(robot_cls, meth, wrapped)


@contextlib.contextmanager
def standins(root, fems, diamond=DIAMOND_BOX, trunk=TRUNK_BOX):
    """Write the stand-ins under root/mesh and point every module of `fems`
    at them, with PLANT_CACHE_DIR at root/plant_cache; restore both on
    exit. Yields the node counts."""
    mesh_dir = os.path.join(root, "mesh")
    counts = write_standins(mesh_dir, diamond, trunk)
    saved = [(f, f.REFERENCE_MESH_DIR, f.PLANT_CACHE_DIR) for f in fems]
    try:
        for f in fems:
            f.REFERENCE_MESH_DIR = mesh_dir
            f.PLANT_CACHE_DIR = os.path.join(root, "plant_cache")
        yield counts
    finally:
        for f, mesh, cache in saved:
            f.REFERENCE_MESH_DIR = mesh
            f.PLANT_CACHE_DIR = cache


def run_port(mod, argv, **kw):
    """A campaign twin's main(argv, **kw): (summary, the gates' failures,
    where the quarantined artifacts went)."""
    from soft_robot_control_tpu_torch.examples.campaign_gates import (
        GatesFailed)

    try:
        return mod.main(list(argv), **kw), [], {}
    except GatesFailed as e:
        return e.summary, e.fails, e.moved


def restore(moved):
    """Copy quarantined artifacts back where the run wrote them."""
    import shutil

    for path, dest in moved.items():
        shutil.copy(dest, path)
