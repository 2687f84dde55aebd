"""Rules of the PyTorch port that hold for every file: it imports neither
JAX nor the JAX package, and its entry points refuse to run on a card that
is not there."""

import ast
import os

import numpy as np
import pytest
import torch

from torch_helpers import CAMPAIGN, REPO, SSM_ARTIFACTS

FORBIDDEN = {"jax", "jaxlib", "soft_robot_control_tpu"}
# The repository's scripts that run on committed data, and their twins in
# the port (examples/ under soft_robot_control_tpu_torch/, but launch)
ENTRY_TWINS = {"launch.py": "launch",
               "examples/batched_serving.py": "batched_serving",
               "examples/realtime_mpc_tpu.py": "realtime_mpc",
               "examples/noisy_batch_mpc_campaign.py":
                   "noisy_batch_mpc_campaign",
               "examples/dubins_gusto.py": "dubins_gusto",
               "examples/diamond_pipeline.py": "diamond_pipeline"}


def _port_files():
    """The package, chip_smoke.py, cluster_probe.py, the port's tools
    (tools/stream_variants.py, tools/pipeline_widths.py), and the card
    tests with their helpers, which run on a machine without JAX."""
    root = os.path.join(REPO, "soft_robot_control_tpu_torch")
    files = [os.path.join(REPO, p) for p in (
        "chip_smoke.py", "cluster_probe.py", "tools/stream_variants.py",
        "tools/pipeline_widths.py", "tests/test_torch_kernels_cuda.py",
        "tests/torch_helpers.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    """First dotted component of every module an import statement names."""
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 24
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"soft_robot_control_tpu_torch/scp/locp.py",
            "soft_robot_control_tpu_torch/ops/admm_single.py",
            "soft_robot_control_tpu_torch/scp/gusto.py",
            "soft_robot_control_tpu_torch/scp/gusto_jit.py",
            "soft_robot_control_tpu_torch/control/service.py",
            "soft_robot_control_tpu_torch/control/linear_mpc.py",
            "soft_robot_control_tpu_torch/models/linear.py",
            "soft_robot_control_tpu_torch/models/dubins.py",
            "soft_robot_control_tpu_torch/models/interfaces.py",
            "soft_robot_control_tpu_torch/core/types.py",
            "soft_robot_control_tpu_torch/ops/monomials.py",
            "soft_robot_control_tpu_torch/models/ssm.py",
            "soft_robot_control_tpu_torch/estimators/ssm_observer.py",
            "soft_robot_control_tpu_torch/qp/structured.py",
            "soft_robot_control_tpu_torch/qp/cyclic_reduction.py",
            "soft_robot_control_tpu_torch/scp/locp_stages.py",
            "soft_robot_control_tpu_torch/scp/standalone.py",
            "soft_robot_control_tpu_torch/estimators/luenberger.py",
            "soft_robot_control_tpu_torch/control/rompc.py",
            "soft_robot_control_tpu_torch/control/policies.py",
            "soft_robot_control_tpu_torch/models/koopman.py",
            "soft_robot_control_tpu_torch/control/koopman.py",
            "soft_robot_control_tpu_torch/estimators/full_state.py",
            "soft_robot_control_tpu_torch/estimators/ekf.py",
            "soft_robot_control_tpu_torch/lqr/tvlqr.py",
            "soft_robot_control_tpu_torch/lqr/ilqr.py",
            "soft_robot_control_tpu_torch/sim/fem_surrogate.py",
            "soft_robot_control_tpu_torch/sim/closed_loop.py",
            "soft_robot_control_tpu_torch/control/mpc.py",
            "soft_robot_control_tpu_torch/control/sequences.py",
            "soft_robot_control_tpu_torch/sim/snapshots.py",
            "soft_robot_control_tpu_torch/models/tpwl_build.py",
            "soft_robot_control_tpu_torch/robots/robots.py",
            "soft_robot_control_tpu_torch/tasks/recipes.py",
            "soft_robot_control_tpu_torch/tasks/calibration.py",
            "soft_robot_control_tpu_torch/tasks/targets.py",
            "soft_robot_control_tpu_torch/tasks/problem.py",
            "soft_robot_control_tpu_torch/tasks/analysis.py",
            "soft_robot_control_tpu_torch/models/ssm_learn.py",
            "soft_robot_control_tpu_torch/tasks/sysid_export.py",
            "soft_robot_control_tpu_torch/tasks/baseline_comparison.py",
            "soft_robot_control_tpu_torch/tasks/plotting.py",
            "soft_robot_control_tpu_torch/utils/geometry.py",
            "soft_robot_control_tpu_torch/utils/timing.py",
            "soft_robot_control_tpu_torch/utils/marshal.py",
            "soft_robot_control_tpu_torch/utils/native.py",
            "soft_robot_control_tpu_torch/utils/gatekeeper.py",
            "soft_robot_control_tpu_torch/parallel/mesh.py",
            "soft_robot_control_tpu_torch/launch.py",
            *(f"soft_robot_control_tpu_torch/examples/{f}.py"
              for f in ENTRY_TWINS.values() if f != "launch"),
            "tools/stream_variants.py", "tools/pipeline_widths.py"} <= names
    bad = {os.path.relpath(f, REPO): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files}
    assert not {f: r for f, r in bad.items() if r}
    # the check compares whole names: the port's own package is allowed
    assert "soft_robot_control_tpu_torch" in _imported_roots(
        os.path.join(REPO, "chip_smoke.py"))


def test_port_imports_matplotlib_only_inside_functions():
    """The card's machine has no matplotlib: no file of the port imports
    it when it is loaded (the plotting modules import it in the function
    that draws)."""
    late = []
    for f in _port_files():
        tree = ast.parse(open(f).read(), filename=f)
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                if any(m and m.split(".")[0] == "matplotlib" for m in mods):
                    late.append(os.path.relpath(f, REPO))
    assert late == []


def _entry_points():
    from soft_robot_control_tpu_torch.control.batch_mpc import BatchMPC
    from soft_robot_control_tpu_torch.models.tpwl import from_tpwl_dict
    from soft_robot_control_tpu_torch.rom.pod import POD
    from soft_robot_control_tpu_torch.scp.locp import LOCP, LOCPSpec
    from soft_robot_control_tpu_torch.control.linear_mpc import (
        LinearMPCService)
    from soft_robot_control_tpu_torch.core.types import QuadraticCost, Target
    from soft_robot_control_tpu_torch.models.dubins import DubinsCar
    from soft_robot_control_tpu_torch.models.linear import (
        LinearROM, tpwl_to_linear_rom)
    from soft_robot_control_tpu_torch.scp.locp_condensed import (
        CondensedLOCPAdapter, CondensedSpec)
    from soft_robot_control_tpu_torch.tasks.demo import make_demo_tpwl
    from soft_robot_control_tpu_torch.control.batch_mpc import BatchSSMMPC
    from soft_robot_control_tpu_torch.models.ssm import from_mat
    from soft_robot_control_tpu_torch.qp.structured import StructuredKKT
    from soft_robot_control_tpu_torch.scp.locp_stages import (
        StageLOCP, StageLOCPAdapter)
    from soft_robot_control_tpu_torch.control.rompc import ROMPC
    from soft_robot_control_tpu_torch.estimators.luenberger import (
        DiscreteLuenbergerObserver)
    from soft_robot_control_tpu_torch.models.koopman import (
        koopman_model_from_arrays, train_edmd)
    from soft_robot_control_tpu_torch.control.koopman import KoopmanMPC
    from soft_robot_control_tpu_torch.sim.fem_surrogate import (
        FEMSurrogate, make_chain_robot)
    from soft_robot_control_tpu_torch.models.convert import (
        surrogate_from_arrays)
    from soft_robot_control_tpu_torch.models.tpwl_build import (
        build_tpwl_model)
    from soft_robot_control_tpu_torch.robots import DiamondRobot
    from soft_robot_control_tpu_torch.tasks.recipes import (collect_pod_data,
                                                            run_scp)
    from soft_robot_control_tpu_torch.models.convert import (
        tet_fem_from_arrays)
    from soft_robot_control_tpu_torch.robots import robots
    from soft_robot_control_tpu_torch.sim.fem_tet import (LEAVES, TetFEM,
                                                          build_tet_fem,
                                                          make_box_mesh)
    from soft_robot_control_tpu_torch.models.ssm_learn import learn_ssm
    from soft_robot_control_tpu_torch.utils import geometry
    from soft_robot_control_tpu_torch.parallel.mesh import make_mesh
    from soft_robot_control_tpu_torch import launch
    from soft_robot_control_tpu_torch.examples import (
        batched_serving, diamond_pipeline, dubins_gusto,
        noisy_batch_mpc_campaign, realtime_mpc)

    rom = {"U": np.eye(4, 2), "q_ref": np.zeros(4), "v_ref": np.zeros(4)}

    class LTI:  # numpy arrays: no device of its own
        A_d, B_d, d_d, H = np.eye(2), np.ones((2, 1)), np.zeros(2), np.eye(2)
        C = np.eye(2)

    cost = QuadraticCost(np.eye(2), np.eye(1))
    scale = {k: np.ones(2 if k[0] == "y" else 1) for k in (
        "y_offset", "y_factor", "u_offset", "u_factor")}

    pts, tets = make_box_mesh(2, 2, 2)
    box = dict(young=100.0, poisson=0.4, total_mass=0.01, alpha=1.0,
               beta=0.01, fixed_box=(-1, -1, -1, 11, 11, 1), dt=0.01,
               cables=[{"waypoints": np.full((1, 3), 5.0)}])
    leaves = {k: np.zeros(1) for k in LEAVES}

    return {
        "from_tpwl_dict": lambda: from_tpwl_dict(CAMPAIGN),
        "POD": lambda: POD(rom),
        "CondensedSpec": lambda: CondensedSpec(2, np.eye(1), np.eye(1),
                                               np.eye(1)),
        "LOCPSpec": lambda: LOCPSpec(2, np.eye(1), np.eye(1), np.eye(1)),
        "LOCP": lambda: LOCP(2, np.eye(1), np.eye(1), np.eye(1)),
        "BatchMPC": lambda: BatchMPC(from_tpwl_dict(CAMPAIGN, device="cpu"),
                                     np.eye(1), np.eye(4), N=2, dt=0.01,
                                     formulation="condensed"),
        "BatchMPC_sparse": lambda: BatchMPC(
            from_tpwl_dict(CAMPAIGN, device="cpu"), np.eye(1), np.eye(4),
            N=2, dt=0.01),
        "CondensedSpec_trust_region": lambda: CondensedSpec(
            2, np.eye(1), np.eye(1), np.eye(1), trust_region=True),
        "CondensedLOCPAdapter": lambda: CondensedLOCPAdapter(
            2, np.eye(1), np.eye(1), np.eye(1)),
        "DubinsCar": lambda: DubinsCar(),
        "make_demo_tpwl": lambda: make_demo_tpwl(r=2, P=3, nf=4),
        "LinearROM": lambda: LinearROM(tpwl_to_linear_rom(CAMPAIGN), 0.01),
        "LinearMPCService": lambda: LinearMPCService(
            LTI(), 2, 0.1, QuadraticCost(np.eye(2), np.eye(1)),
            Target(z=np.zeros(2)), locp_backend="condensed"),
        "from_mat": lambda: from_mat(SSM_ARTIFACTS["trunk"], None),
        "BatchSSMMPC": lambda: BatchSSMMPC(
            from_mat(SSM_ARTIFACTS["trunk"], None, device="cpu"),
            np.eye(6), np.eye(8), N=3, dt=0.02),
        "StructuredKKT": lambda: StructuredKKT(3, 2, 1),
        "StageLOCP": lambda: StageLOCP(3, np.eye(2), np.eye(2), np.eye(1)),
        "StageLOCPAdapter": lambda: StageLOCPAdapter(
            3, np.eye(2), np.eye(2), np.eye(1)),
        "DiscreteLuenbergerObserver": lambda: DiscreteLuenbergerObserver(
            LTI(), np.eye(2), np.eye(2)),
        "ROMPC": lambda: ROMPC(LTI(), cost, cost, 0.1),
        "KoopmanModel": lambda: koopman_model_from_arrays(
            np.eye(3), np.ones((3, 1)), np.eye(2, 3), n=2, m=1, nzeta=2,
            delays=0, obs_degree=1, Ts=0.1, scale_dict=scale),
        "train_edmd": lambda: train_edmd(np.ones((4, 2)), np.ones((4, 1)),
                                         degree=1),
        "KoopmanMPC": lambda: KoopmanMPC(LTI()),
        "make_chain_robot": lambda: make_chain_robot(n_nodes=3),
        "FEMSurrogate": lambda: FEMSurrogate(np.eye(2), 1.0, 0.1, 0.1, 1.0,
                                             np.zeros(2), np.ones((2, 1))),
        "surrogate_from_arrays": lambda: surrogate_from_arrays(
            {"K": np.eye(2), "m_node": 1.0, "alpha": 0.1, "beta": 0.1,
             "gamma": 1.0, "q_rest": np.zeros(2), "H": np.ones((2, 1))}),
        "build_tpwl_model": lambda: build_tpwl_model(
            make_chain_robot(n_nodes=2, n_cables=1, device="cpu"),
            POD({"U": np.eye(2, 1), "q_ref": np.zeros(2),
                 "v_ref": np.zeros(2)}, device="cpu"),
            np.zeros((3, 4)), np.zeros((3, 1))),
        "DiamondRobot": lambda: DiamondRobot(n_nodes=3),
        "collect_pod_data": lambda: collect_pod_data(DiamondRobot(n_nodes=3),
                                                     os.devnull),
        "run_scp": lambda: run_scp(DiamondRobot(n_nodes=3), os.devnull,
                                   np.zeros(2), np.zeros((2, 1))),
        "build_tet_fem": lambda: build_tet_fem(pts, tets, **box),
        "TetFEM": lambda: TetFEM(*leaves.values(), 0.01),
        "tet_fem_from_arrays": lambda: tet_fem_from_arrays(
            {**leaves, "dt": 0.01, "cg_iters": 80, "cg_tol": 1e-6}),
        "DiamondTetRobot": lambda: robots.DiamondTetRobot(
            mesh_path=os.devnull, cache=False),
        "learn_ssm": lambda: learn_ssm(
            [np.random.default_rng(0).normal(size=(40, 2))], 0.01,
            state_dim=2, SSM_order=1, ROM_order=1, z_ref=np.zeros(2)),
        "quat_identity": lambda: geometry.quat_identity(),
        "trs_to_matrix": lambda: geometry.trs_to_matrix([1.0, 2.0, 3.0]),
        "make_mesh": lambda: make_mesh(1),
        "launch": lambda: launch.main(["finger", "compute_pod_basis",
                                       "--save-dir", os.devnull]),
        "batched_serving": lambda: batched_serving.main(["--batch", "1"]),
        "realtime_mpc": lambda: realtime_mpc.main(["--seconds", "0.1"]),
        "noisy_batch_mpc_campaign": lambda: noisy_batch_mpc_campaign.main(
            ["--out", os.devnull]),
        "dubins_gusto": lambda: dubins_gusto.main([]),
        "diamond_pipeline": lambda: diamond_pipeline.main(
            ["--save-dir", os.devnull]),
    }


@pytest.mark.parametrize("name", ["from_tpwl_dict", "POD", "CondensedSpec",
                                  "LOCPSpec", "LOCP", "BatchMPC",
                                  "BatchMPC_sparse",
                                  "CondensedSpec_trust_region",
                                  "CondensedLOCPAdapter", "DubinsCar",
                                  "make_demo_tpwl", "LinearROM",
                                  "LinearMPCService", "from_mat",
                                  "BatchSSMMPC", "StructuredKKT",
                                  "StageLOCP", "StageLOCPAdapter",
                                  "DiscreteLuenbergerObserver", "ROMPC",
                                  "KoopmanModel", "train_edmd",
                                  "KoopmanMPC", "make_chain_robot",
                                  "FEMSurrogate", "surrogate_from_arrays",
                                  "build_tpwl_model", "DiamondRobot",
                                  "collect_pod_data", "run_scp",
                                  "build_tet_fem", "TetFEM",
                                  "tet_fem_from_arrays", "DiamondTetRobot",
                                  "learn_ssm", "quat_identity",
                                  "trs_to_matrix", "make_mesh", "launch",
                                  "batched_serving", "realtime_mpc",
                                  "noisy_batch_mpc_campaign",
                                  "dubins_gusto", "diamond_pipeline"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def _reexported_names(init_path):
    """The names an __init__.py binds through `from ... import` lines."""
    tree = ast.parse(open(init_path).read(), filename=init_path)
    return sorted(a.asname or a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("sub", ["scp", "qp", "core", "lqr", "estimators",
                                 "rom", "robots", "parallel"])
def test_subpackages_reexport_the_jax_names(sub):
    """Each subpackage's re-exports are the JAX subpackage's: for example
    `from soft_robot_control_tpu_torch.scp import GuSTO` works. (The JAX
    `parallel/__init__.py` binds no names, so the port's binds none.)"""
    import importlib

    jax_pkg = importlib.import_module(f"soft_robot_control_tpu.{sub}")
    port = importlib.import_module(f"soft_robot_control_tpu_torch.{sub}")
    names = _reexported_names(jax_pkg.__file__)
    assert names or sub == "parallel"
    assert all(hasattr(jax_pkg, n) for n in names)
    assert [n for n in names if not hasattr(port, n)] == []
    assert _reexported_names(port.__file__) == names


# Public names of ported JAX files that later slices bring, each with its
# ROADMAP.md section 1 item (none is left)
LEFT_TO_LATER = {}


def _public_names(path):
    """A JAX file's public top-level names: its functions, classes and
    assigned names (not starting with '_'), `__version__`, and, in an
    __init__.py, the names its imports bind."""
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.add(node.target.id)
        elif (os.path.basename(path) == "__init__.py"
              and isinstance(node, ast.ImportFrom)):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def test_ported_files_have_the_jax_public_names():
    """Every public top-level name of a JAX file that has a twin in the
    port exists in the twin (defined or bound there), but for the names
    LEFT_TO_LATER lists."""
    import importlib

    jroot = os.path.join(REPO, "soft_robot_control_tpu")
    missing, twins = {}, 0
    for d, _, files in os.walk(jroot):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), jroot)
            twin = os.path.join(REPO, "soft_robot_control_tpu_torch", rel)
            if not os.path.exists(twin):
                continue
            twins += 1
            mod = "soft_robot_control_tpu_torch." + rel[:-3].replace(
                os.sep, ".")
            mod = mod.removesuffix(".__init__")
            port = importlib.import_module(mod)
            gap = {n for n in _public_names(os.path.join(d, f))
                   if not hasattr(port, n)}
            gap -= LEFT_TO_LATER.get(rel.replace(os.sep, "/"), set())
            if gap:
                missing[rel] = sorted(gap)
    assert twins > 60
    assert missing == {}
    # the allow-list names only what the port still lacks
    for rel, names in LEFT_TO_LATER.items():
        port = importlib.import_module(
            "soft_robot_control_tpu_torch." + rel[:-3].replace("/", "."))
        assert not any(hasattr(port, n) for n in names), rel
        assert names <= _public_names(os.path.join(jroot, rel)), rel


@pytest.mark.parametrize("script", sorted(ENTRY_TWINS))
def test_entry_scripts_have_twins_with_their_public_names(script):
    """launch.py and the example scripts that need no reference mesh each
    have a twin in the port with the script's public names (get_robot,
    default_target, main)."""
    import importlib

    twin = ENTRY_TWINS[script]
    mod = importlib.import_module(
        "soft_robot_control_tpu_torch." + ("" if twin == "launch"
                                           else "examples.") + twin)
    names = _public_names(os.path.join(REPO, script))
    assert "main" in names
    assert [n for n in names if not hasattr(mod, n)] == []
