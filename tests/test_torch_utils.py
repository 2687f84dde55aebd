"""The port's utilities against the JAX package, on the CPU: utils/
geometry.py (against the JAX functions and scipy's rotations, batched
too), utils/timing.py, utils/marshal.py, utils/native.py (the library
built from csrc/srk_io.cpp and the numpy branch, each reading what the
other and the JAX package write) and utils/gatekeeper.py (a temporary git
repository with a failing gate). Tolerances are stated beside each
assertion."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp

from soft_robot_control_tpu.utils import geometry as jg
from soft_robot_control_tpu.utils import marshal as jm
from soft_robot_control_tpu.utils import native as jn
from soft_robot_control_tpu_torch.utils import gatekeeper as tgate
from soft_robot_control_tpu_torch.utils import geometry as g
from soft_robot_control_tpu_torch.utils import marshal as tm
from soft_robot_control_tpu_torch.utils import native as tn
from soft_robot_control_tpu_torch.utils import timing

import torch_helpers  # noqa: F401  (single-threaded torch)

GEOM_TOL = 1e-12   # f64, the same formulas summed in the same order


def _t(a):
    return torch.as_tensor(np.asarray(a, float))


def _same(got, ref, tol=GEOM_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=tol)


@pytest.fixture(scope="module")
def quats():
    rng = np.random.default_rng(1)
    return (Rotation.random(6, random_state=rng).as_quat(),
            Rotation.random(6, random_state=rng).as_quat(),
            rng.normal(size=(6, 3)))


def test_vectors_are_the_jax_packages():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    _same(g.vnorm(_t(a)), jg.vnorm(jnp.asarray(a)))
    _same(g.vnormalize(_t(a)), jg.vnormalize(jnp.asarray(a)))
    _same(g.vdot(_t(a), _t(b)), jg.vdot(jnp.asarray(a), jnp.asarray(b)))
    _same(g.vcross(_t(a), _t(b)), jg.vcross(jnp.asarray(a),
                                            jnp.asarray(b)))
    # one vector against a batch broadcasts
    _same(g.vcross(_t(a[0]), _t(b)), jg.vcross(jnp.asarray(a[0]),
                                               jnp.asarray(b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rodrigues_rotation_is_scipys_and_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    axis, angle = rng.normal(size=3), rng.uniform(-np.pi, np.pi)
    v = rng.normal(size=(4, 3))
    got = g.vrotate_axis_angle(_t(v), list(axis), angle)
    R = Rotation.from_rotvec(angle * axis / np.linalg.norm(axis))
    _same(got, R.apply(v), 1e-10)
    _same(got, jg.vrotate_axis_angle(jnp.asarray(v), axis, angle))


def test_quaternions_are_scipys_and_the_jax_packages(quats):
    """Batched products, rotations, matrices and conjugates: within 1e-10
    of scipy (up to the quaternion's sign) and GEOM_TOL of JAX."""
    q1, q2, v = quats
    got = g.quat_mul(_t(q1), _t(q2))
    _same(got, jg.quat_mul(jnp.asarray(q1), jnp.asarray(q2)))
    ref = (Rotation.from_quat(q1) * Rotation.from_quat(q2)).as_quat()
    sign = np.sign(np.sum(got.numpy() * ref, axis=1))[:, None]
    _same(got * _t(sign), ref, 1e-10)
    _same(g.quat_rotate(_t(q1), _t(v)), Rotation.from_quat(q1).apply(v),
          1e-10)
    _same(g.quat_rotate(_t(q1), _t(v)),
          jg.quat_rotate(jnp.asarray(q1), jnp.asarray(v)))
    _same(g.quat_to_matrix(_t(q1)), Rotation.from_quat(q1).as_matrix(),
          1e-10)
    _same(g.quat_conjugate(_t(q1)), jg.quat_conjugate(jnp.asarray(q1)))
    _same(g.quat_normalize(_t(3.0 * q1)),
          jg.quat_normalize(jnp.asarray(3.0 * q1)))
    _same(g.quat_identity(device="cpu"), jg.quat_identity())


@pytest.mark.parametrize("angles", [[30.0, -45.0, 60.0], [0.0, 90.0, 0.0],
                                    [170.0, 10.0, -120.0]])
def test_euler_and_axis_angle_are_scipys_and_the_jax_packages(angles):
    q = g.quat_from_euler(*angles, degrees=True, device="cpu")
    ref = Rotation.from_euler("XYZ", angles, degrees=True).as_quat()
    assert (np.allclose(q.numpy(), ref, atol=1e-10)
            or np.allclose(q.numpy(), -ref, atol=1e-10))
    _same(q, jg.quat_from_euler(*angles, degrees=True))
    rad = np.deg2rad(angles)
    _same(g.quat_from_euler(*[_t(a) for a in rad]),
          jg.quat_from_euler(*rad))
    axis = [1.0, 2.0, -0.5]
    _same(g.quat_from_axis_angle(axis, rad[0], device="cpu"),
          jg.quat_from_axis_angle(axis, rad[0]))
    # a batch of angles about one axis
    _same(g.quat_from_axis_angle(_t(axis), _t(rad)),
          jg.quat_from_axis_angle(jnp.asarray(axis), jnp.asarray(rad)))


@pytest.mark.parametrize("rot", ["none", "euler", "quaternion"])
def test_trs_to_matrix_is_the_jax_packages(rot):
    kw = {"none": {}, "euler": dict(rotation_euler_deg=[10.0, 20.0, 90.0]),
          "quaternion": dict(quaternion=[0.1, 0.2, 0.3, 0.9])}[rot]
    M = g.trs_to_matrix([1.0, 2.0, 3.0], scale=[2.0, 1.0, 0.5],
                        device="cpu", **kw)
    J = jg.trs_to_matrix([1.0, 2.0, 3.0], scale=[2.0, 1.0, 0.5], **kw)
    _same(M, J)
    pts = np.random.default_rng(3).normal(size=(7, 3))
    _same(g.transform_points(M, pts), jg.transform_points(J, pts))
    _same(g.trs_to_matrix([0.0, 0.0, 0.0], device="cpu"), np.eye(4))


def test_timer_and_block_time(tmp_path):
    """Timer's statistics of its samples; block_time of a call whose
    output holds CPU tensors (nothing to synchronize); trace writes a
    profiler trace into its directory."""
    t = timing.Timer()
    for _ in range(3):
        with t.section("a"):
            pass
    t.start("b")
    dt = t.stop("b")
    st = t.stats()
    assert sorted(st) == ["a", "b"] and st["a"]["count"] == 3
    assert st["b"]["total"] == dt == t.stats("b")["max"]
    assert st["a"]["min"] <= st["a"]["mean"] <= st["a"]["max"]
    x = torch.ones(64, 64, dtype=torch.float64)
    s = timing.block_time(lambda a: {"y": [a @ a, (a, 1)]}, x)
    assert 0.0 < s < 10.0
    assert timing._devices({"y": [x, (x, None)]}, set()) == set()
    with timing.trace(str(tmp_path / "trace")):
        (x @ x).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def test_marshal_is_the_jax_packages():
    x = list(np.arange(12.0))
    for dim, sq in ((3, False), (12, True), (1, True)):
        assert np.array_equal(tm.arr2np(x, dim, sq), jm.arr2np(x, dim, sq))
    a = np.arange(6.0).reshape(2, 3)
    assert tm.np2arr(a) == jm.np2arr(a) == tm.np2arr(torch.as_tensor(a))
    assert np.array_equal(tm.arr2np(torch.as_tensor(a), 3), a)


def _matrix_file(path, M):
    """A header line, then bracketed rows: the SOFA LDL export's layout."""
    with open(path, "w") as f:
        f.write("# header to skip\n")
        for row in M:
            f.write("[" + " ".join(f"{v:.12g}" for v in row) + "]\n")


@pytest.fixture(params=["library", "numpy"])
def native_branch(request, monkeypatch):
    """The port's native module with its built library, or with its
    numpy branch (no compiler)."""
    if request.param == "library":
        assert tn.native_available()
        assert os.path.dirname(tn.library_path()).endswith(
            os.path.join("build", "native"))
    else:
        monkeypatch.setattr(tn, "_load", lambda: None)
        assert not tn.native_available()
    return request.param


def test_parse_matrix_txt_is_the_jax_packages(native_branch, tmp_path):
    """Both branches parse to the JAX package's result exactly (bracketed
    rows after a header; plain whitespace); a wrong size raises."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(40, 37))
    path = str(tmp_path / "mat.txt")
    _matrix_file(path, M)
    got = tn.parse_matrix_txt(path, 40, 37, skip_lines=1)
    assert np.array_equal(got, jn.parse_matrix_txt(path, 40, 37,
                                                   skip_lines=1))
    np.testing.assert_allclose(got, M, rtol=1e-10)
    path2 = str(tmp_path / "plain.txt")
    np.savetxt(path2, M[:5, :4])
    assert np.array_equal(tn.parse_matrix_txt(path2, 5, 4),
                          jn.parse_matrix_txt(path2, 5, 4))
    with pytest.raises(ValueError):
        tn.parse_matrix_txt(path2, 5, 5)


def test_snaplog_round_trips_across_packages(native_branch, tmp_path):
    """A log written by either branch (one record at a time, then many)
    reads back exactly through the port, the JAX package and the other
    branch; a record of the wrong width raises."""
    rng = np.random.default_rng(2)
    recs = rng.normal(size=(123, 9))
    path = str(tmp_path / "log.snap")
    with tn.SnapLog(path, 9) as log:
        for r in recs[:23]:
            log.append(r)
        log.append_many(recs[23:])
        with pytest.raises(ValueError):
            log.append(np.zeros(5))
    assert np.array_equal(tn.read_snaplog(path), recs)
    assert np.array_equal(jn.read_snaplog(path), recs)
    jpath = str(tmp_path / "jax.snap")
    with jn.SnapLog(jpath, 9) as log:
        log.append_many(recs)
    assert np.array_equal(tn.read_snaplog(jpath), recs)


def _git(repo, *args):
    subprocess.run(["git", *args], cwd=repo, check=True,
                   capture_output=True)


def test_gatekeeper_quarantines_and_restores(tmp_path, monkeypatch):
    """A temporary git repository with a committed artifact: a green gate
    (which also sees JAX_PLATFORMS=cpu) leaves the new artifact in place
    and returns 0; a red gate moves it to <out>/rejected/ and restores
    the committed version with git checkout, and an untracked artifact is
    moved only."""
    repo = tmp_path / "repo"
    out = repo / "out"
    out.mkdir(parents=True)
    _git(repo, "init", "-q")
    _git(repo, "config", "user.email", "t@example.com")
    _git(repo, "config", "user.name", "t")
    art = out / "model.txt"
    art.write_text("committed\n")
    _git(repo, "add", "out/model.txt")
    _git(repo, "commit", "-q", "-m", "artifact")
    green = repo / "gate_green.py"
    green.write_text("import os\n\ndef test_env():\n"
                     "    assert os.environ['JAX_PLATFORMS'] == 'cpu'\n")
    red = repo / "gate_red.py"
    red.write_text("def test_gate():\n    assert False\n")
    monkeypatch.chdir(repo)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    art.write_text("this run\n")
    assert tgate.enforce_gates([str(green)], [str(art)], str(out)) == 0
    assert art.read_text() == "this run\n"
    new = out / "new.txt"
    new.write_text("untracked\n")
    rc = tgate.enforce_gates([str(red), str(green)], [str(art), str(new)],
                             str(out), k="gate")
    assert rc != 0
    assert art.read_text() == "committed\n" and not new.exists()
    moved = sorted(os.listdir(out / "rejected"))
    assert [m.split("-", 2)[-1] for m in moved] == ["model.txt", "new.txt"]
    assert (out / "rejected" / moved[0]).read_text() == "this run\n"
    assert tgate._repo_root(str(art)) == str(repo.resolve())
    assert tgate._is_tracked(str(repo), str(art))
    assert not tgate._is_tracked(str(repo), str(green))
