"""Running the campaign scripts of both packages side by side on the CPU in
float64, on the stand-in meshes of tests/tet_standins.py: the JAX scripts
(examples/*.py, loaded from their files and run in-process with their
argv) and their twins under soft_robot_control_tpu_torch/examples/.

The JAX scripts end with `utils/gatekeeper.py:enforce_gates`, which runs
pytest on the committed examples/diamond_tet/ and examples/trunk_tet/
artifacts, not on the run; the runs here replace it with a stub that
passes. The twins' gates read the run's own --out and run for real; on the
stand-ins they fail (the gates name the real meshes' sizes), so a twin's
run ends in GatesFailed with its artifacts quarantined."""

import contextlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

import tet_standins as S
from tet_standins import restore, run_port  # noqa: F401 (the tests' helpers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name, folder="examples"):
    """<folder>/<name>.py as a module (the JAX script)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{folder}_{name}", os.path.join(REPO, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mod, argv):
    """The JAX script's main with argv (its enforce_gates stubbed)."""
    from soft_robot_control_tpu.utils import gatekeeper

    saved_argv, saved_gate = sys.argv, gatekeeper.enforce_gates
    sys.argv = [mod.__file__] + list(argv)
    gatekeeper.enforce_gates = lambda *a, **k: 0
    try:
        mod.main()
    finally:
        sys.argv, gatekeeper.enforce_gates = saved_argv, saved_gate


@contextlib.contextmanager
def campaign_standins(root):
    """Both packages' builders on the small stand-ins (one plant cache for
    both), the Diamond's node literals mapped onto the small box."""
    from soft_robot_control_tpu.robots import robots as jrobots
    from soft_robot_control_tpu.sim import fem_tet as J
    from soft_robot_control_tpu_torch.robots import robots as trobots
    from soft_robot_control_tpu_torch.sim import fem_tet as P

    with S.standins(root, [P, J], diamond=S.DIAMOND_SMALL,
                    trunk=S.TRUNK_SMALL) as counts, \
            pytest.MonkeyPatch.context() as mp:
        for cls in (jrobots.DiamondTetRobot, trobots.DiamondTetRobot):
            S.map_nodes(mp, cls, S.DIAMOND_SMALL_NODES)
        yield counts


def load_json(path):
    with open(path) as f:
        return json.load(f)


def same_summaries(got, ref, rtol, atol=0.0, skip=()):
    """The summaries have the same keys, equal integers, strings and
    booleans, and floats within rtol (relative) or atol, NaN where the
    other is; keys in skip (wall-clock times) are compared by presence
    only."""
    assert set(got) == set(ref), (sorted(set(got) ^ set(ref)))
    for k, v in ref.items():
        if k in skip:
            continue
        g = got[k]
        if isinstance(v, dict):
            same_summaries(g, v, rtol, atol, skip)
        elif isinstance(v, (bool, str)) or v is None:
            assert g == v, (k, g, v)
        elif isinstance(v, int):
            assert g == v and type(g) is type(v), (k, g, v)
        elif isinstance(v, list):
            np.testing.assert_allclose(g, v, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=k)
        elif np.isnan(v):
            assert np.isnan(g), (k, g, v)
        else:
            assert abs(g - v) <= max(rtol * abs(v), atol), (k, g, v)


def same_arrays(a, b, rel, where=""):
    """Two loaded artifacts (dicts, lists, arrays, scalars) equal array
    for array: floats within `rel` of each array's largest magnitude,
    the rest exactly. A list of arrays of one shape (a snapshot list) is
    one array."""
    if isinstance(a, list) and len(a) and all(
            isinstance(v, np.ndarray) and v.shape == a[0].shape for v in a):
        a, b = np.stack(a), np.stack(b)
    if hasattr(a, "_asdict") or hasattr(a, "__dict__"):
        # a package's own type (QuadraticCost, ...): by name and fields
        assert type(a).__name__ == type(b).__name__, where
        a, b = ((v._asdict() if hasattr(v, "_asdict") else vars(v))
                for v in (a, b))
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(set(a) ^ set(b)))
        for k in a:
            same_arrays(a[k], b[k], rel, f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and not all(
            np.isscalar(v) for v in a):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_arrays(x, y, rel, f"{where}[{i}]")
    elif isinstance(a, str) or a is None:
        assert a == b, where
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, (where, x.shape, y.shape)
        if x.dtype.kind in "fc" and x.size:
            gap = np.abs(x - y).max()
            assert gap <= rel * max(np.abs(x).max(), 1e-300), (where, gap)
        else:
            assert np.array_equal(x, y), where


def pod_signs(jax_U, port_U):
    """The sign of each port basis column against the JAX one (the SVD
    leaves each column's sign free, and the packages' SVDs differ)."""
    return np.sign(np.sum(np.asarray(jax_U) * np.asarray(port_U), axis=0))


def port_in_jax_signs(d, s):
    """A port TPWL dictionary or POD pickle with its basis columns, and
    every reduced quantity, turned to the JAX basis' signs s."""
    s2 = np.concatenate([s, s])
    out = dict(d)
    if "POD_info" in d:
        out["POD_info"] = dict(d["POD_info"], U=np.asarray(
            d["POD_info"]["U"]) * s)
        return out
    out["rom_info"] = dict(d["rom_info"], U=np.asarray(d["rom_info"]["U"])
                           * s)
    for k in ("q", "v"):
        out[k] = np.asarray(d[k]) * s
    for k in ("A_c", "A_d"):
        out[k] = s2[:, None] * np.asarray(d[k]) * s2[None, :]
    for k in ("B_c", "B_d"):
        out[k] = s2[:, None] * np.asarray(d[k])
    for k in ("d_c", "d_d"):
        out[k] = s2 * np.asarray(d[k])
    return out


def load_pickle(path):
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


def real_plant_caches():
    """The files in both packages' real plant caches."""
    from soft_robot_control_tpu.sim import fem_tet as J
    from soft_robot_control_tpu_torch.sim import fem_tet as P

    return {d: sorted(os.listdir(d)) if os.path.isdir(d) else []
            for d in (J.PLANT_CACHE_DIR, P.PLANT_CACHE_DIR)}
