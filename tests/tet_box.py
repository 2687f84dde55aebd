"""tests/test_fem_tet.py:51-61's box plant, written once for the port's
CPU tests, its card test and chip_smoke.py: make_box_mesh(3, 3, 5) at
spacing 10, fixed at its base, two cables. JAX-free; importing it changes
nothing."""

import numpy as np

# build_tet_fem's keywords besides the mesh and the cables
BOX_BUILD = dict(young=200.0, poisson=0.45, total_mass=0.05, alpha=0.5,
                 beta=0.02, fixed_box=(-1.0, -1.0, -1.0, 21.0, 21.0, 1.0),
                 dt=0.01)


def box_cables():
    return [{"waypoints": np.array([[10.0, 10.0, 38.0]]),
             "pull_point": np.array([10.0, 10.0, 0.0])},
            {"waypoints": np.array([[2.0, 10.0, 15.0], [2.0, 10.0, 25.0],
                                    [2.0, 10.0, 38.0]])}]


def box_plant(fem, **kw):
    """The box built by `fem` (either package's sim/fem_tet module), with
    BOX_BUILD's keywords updated by kw (device=..., gravity=...)."""
    pts, tets = fem.make_box_mesh(3, 3, 5, spacing=10.0)
    return fem.build_tet_fem(pts, tets, cables=box_cables(),
                             **{**BOX_BUILD, **kw})
