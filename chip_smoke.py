"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it goes wrong:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: the five CUDA kernels from soft_robot_control_tpu_torch/csrc, one
   nvcc each, started together;
3. kernel 1 (batched ADMM for QPs that fit a block) against its plain
   PyTorch version on condensed QPs (n=20, m=40, its register form) that
   the port assembles from the Diamond campaign dictionary, and on random
   QPs of n=100, m=120 (its block form), in f64 and f32, at B=1024, 1, 3;
   timed at B=1024 with 25 iterations and with none, whose difference is
   the time of the iterations apart from the loads;
4. kernel 2 (TPWL select and gather) against its plain version on 5120
   states near the campaign dictionary (P=1087, r=30), at B=5120, at a
   ragged B=5119, and at B=3072 with rows for the last two thirds only
   (index_only=1024, as the tick calls it); timed as the plan launch
   (B=5120), the tick launch (B=3072, index_only=1024) and an index-only
   launch (B=5120, index_only=5120: the select without the gather);
5. kernel 3 in its two forms against the same plain version on sparse QPs
   (n=380, m=400, one-sided rows with infinite bounds) assembled,
   equilibrated and rho-folded as the fused sparse loop builds them, at
   B=64, 1, 3, each timed at B=1024 in f32: the streaming form
   (admm_stream, a cluster of 8 blocks a QP with the rows that do not fit
   their shared memory walked in place) in f64 and f32, also timed in f64,
   its plan and the clusters in flight printed; the cluster-resident form
   (admm_cluster, QP held across a thread-block cluster's shared memory) in f32 and, since the f64 QP of
   that size fits no cluster, in f64 on the same loop's QPs at horizon 3
   (n=252, m=264). The clusters the card holds at one time are printed,
   and clusters of 6 and of 8 blocks are timed in turns. Then the
   streaming kernel's range: where its plan for square QPs ends in f32
   and f64 (the built source against the Python plan), and one f64 QP at
   n = m = 2641 (past the full-slot plan's end: x~ received in windows)
   held to its plain version within ADMM_F64_TOL of the solution's scale;
6. kernel 4 (single-QP ADMM through M1, one cluster) against its plain
   version on one such QP prepared as the single-trajectory loop prepares
   it, f64 (walked in place through L2) and f32 (resident), 50 iterations;
7. the condensed path: BatchMPC, condensed, build_fused at B=1024 for 4
   windows with bench.py's quality-gated settings, on the full campaign
   artifact. The tracking error against dynamically feasible targets must
   be <= 0.05, kernels 1 and 2 must have been launched 4 and 3 times a
   window, and B=8 runs on the card, in f32 and in f64, must agree with
   the port's f64 CPU run of the same loop. A profiler pass records where
   the device time of one run goes;
8. path A, the fused sparse loop: BatchMPC, sparse, build_fused at B=1024
   for 4 windows (K^-1 x-step, 100 iterations in 4 rho stages, 6 Ruiz
   iterations, R = 1e-5 I), with the same checks through admm_cluster and
   kernel 2 in f32, plus the peak device memory; its f64 run on the card
   must go through admm_stream;
9. path B, the single-trajectory sparse loop: BatchMPC(use_pallas=True),
   build for 10 windows (50 iterations, R = 1e-3 I): one launch of kernel 4
   and three of kernel 2 a window, finite logs, agreement of the f32 and
   the f64 card runs with the f64 CPU run, and a profiler pass;
10. GuSTO fused, condensed: GuSTOJit(TPWLGuSTO(model), N=5, Qz=100 I,
   R=1e-3 I, cables in [0, 1500], 5 SCP iterations of 50 ADMM iterations,
   K^-1 x-step).solve_batch_fused at B=64 on bench.py:280-291's inputs:
   kernel 1 (block form, n=21, m=641, per-QP A) against its plain version
   on the first iteration's LOCPs and timed in f32 and f64, kernel 2
   against its plain version on the first iteration's select calls (320
   states on the discrete tables, 640 on the continuous ones); one launch
   of kernel 1 and two of kernel 2 an SCP iteration; solves/s, the
   converged share, device time by kernel;
11. GuSTO fused, sparse: the same with formulation="sparse" (n=386,
   m=1126, beyond a cluster): the streaming kernel 3, in f32 and f64;
12. GuSTO real-time: GuSTO(TPWLGuSTO(model), condensed backend,
   device_tr=True) behind GuSTOService for 4 MPC queries; only kernel 2
   launches (the QP runs in plain PyTorch, as in XLA in the JAX package),
   and it is held to its plain version at the queries' shapes; ms a query;
13. the LTI service: LinearMPCService(LinearROM(tpwl_to_linear_rom(
   artifact)), N=20, QuadraticCost(100 I, 1e-4 I, Qf=1000 I), condensed)
   at bench.py:406-432's settings, a step timed with qp_backend "pallas"
   (4 launches of kernel 1, n=80, m=160, B=1, also timed alone) and "xla".
Paths 10-13 also run in f64 on the card and on the CPU (10 and 11 at
their full B=64): identical iteration counts and flags, x and u within
F64_CPU_AGREE_TOL of their scale; their f32 runs must be finite and within
the tolerances stated below.
14. BatchSSMMPC fused: bench.py section 5 (bench.py:368-388) on the
   trunk SSM artifact, BatchSSMMPC(Qz on the tip's x and y = 100, R = 1e-6
   I, N=3, dt=0.02, N_replan=2, 50 ADMM iterations).build_fused at B=1024
   for 4 windows from rest, on the seeded circle targets, f32, in both
   formulations (condensed: kernel 1's register form at n=24, m=1; sparse:
   its block form at n=48, m=24): kernel 1 against its plain version on
   the first window's launch in f32 and f64, with the f32 rounding ratio;
   exactly one launch of kernel 1 a window and none of the others; the
   f64 card run against the f64 CPU run at B=1024 (outputs about z_ref and
   commands within F64_CPU_AGREE_TOL of their scale) and the f32 run within
   SSM_F32_TOL; windows/s as bench.py times it, kernel 1 timed alone beside
   its bound, a profiler pass. Then the Diamond SSM artifact at B=64 in
   both formulations (n=12, m=1 and n=36, m=24): the same launch counts,
   kernel check and agreement with the CPU, untimed.
15. the stage LOCP: bench.py section 4b (bench.py:301-332), StageLOCP
   at N=200 on the campaign dictionary's first point, 100 ADMM
   iterations, kkt_solver 'cr' and 'scan': no kernel of the port (the JAX
   package computes it in XLA); ms a solve, device operations a solve and
   the device's busy share, f32 and f64 card runs against the f64 CPU run,
   'cr' against 'scan';
16. GuSTO's stage backend through run_gusto_standalone at N=200: the
   Dubins car (tests/test_locp_stages.py:228-252's settings) and the
   campaign dictionary through TPWLGuSTO; LOCP solves counted, ms an SCP
   iteration; kernel 2 counted and held to its plain version on the first
   call of each shape and table, and timed at the linearization's 200
   states; f32 and f64 on the card, f64 on the CPU (the campaign's loop
   there only its first LOCP: the whole loop takes minutes); the
   campaign's runs cut to STAGE_GUSTO_SCP_ITERS SCP iterations;
17. ROMPC at examples/diamond_baselines_campaign.py:130-137's settings on
   the campaign's linear ROM, the LinearROM as the plant, 18 ticks (4
   replans) after a 2-tick delay: kernel 1 (condensed LOCP, B=1, n=80, one
   placeholder row) 4 launches a solve, held to its plain version on the
   first QP and timed; host-adapter fallbacks counted; ms a replan; f32
   and f64 on the card against f64 on the CPU;
18. Koopman MPC at the campaign's settings (tasks/recipes.py:417-435),
   the model trained by the port's train_edmd on a seeded rollout of the
   campaign dictionary, the dictionary as the plant: kernel 1 (B=1, n=40,
   m=152) 6 launches a solve, the same checks and reports as 17.
19. the golden chain loop: tests/test_golden.py's closed loop (the chain
   FEM surrogate, its TPWL model and output maps from the committed
   tests/golden/chain_pipeline_arrays.npz, GuSTOService(N=5, dense backend)
   behind scp(N_replan=2, mpc=True), the EKF, 3 s at dt=0.02) through
   run_closed_loop in f64 on the card, held to
   tests/golden/closed_loop_chain.npz at the golden test's tolerances (z
   rtol 1e-6, atol 1e-9; u rtol 1e-5, atol 1e-8); kernel 2 the only
   kernel, held to its plain version on its first call of each shape and
   table; ms a tick and a replan, launches a tick and a replan;
20. the Diamond campaign's closed loop at full width
   (examples/diamond_tet_campaign.py:158-190, tasks/recipes.py:212-268):
   GuSTOService(TPWLGuSTO, N=10, dt=0.01, Qz = diag(100, 100, 0), R = 1e-5
   I, U = [0, 1500]^4, one LOCP a query, no trust region, condensed,
   oneshot_iters=2, plan_bound=60, polish off) behind scp(N_replan=2,
   mpc=True, feedback=True) with 1087 DARE gains, the EKF, the figure-8
   target, commands clamped to [0, 1500]; the plant the dictionary lifted
   to the 9768-dim full state through its POD basis (a stand-in for the
   tet-FEM plant, whose mesh is not in the repository); the delay cut to 2
   ticks, then 20 ticks. f32 on the card (timed; kernel 2 held to its
   plain version on its first call of each shape, and timed at B=1), f64
   on the card against f64 on the CPU (z and u within F64_CPU_AGREE_TOL of
   their scale), f32 within CAMPAIGN_F32_TOL; the f32 DARE gains against
   the f64 ones; a profiler pass (busy share, device operations a tick);
21. the other policies on the same model and plant, 10 ticks each after
   the delay, f64 on the card against f64 on the CPU: ilqr (tf = 0.2 s, 20
   steps, iLQRConfig defaults; launches of kernel 2 an iteration),
   TrajTracking along a rollout of the dictionary, StateDLQR and StateCLQR
   at a dictionary point; ms a policy computation;
22. the Diamond pipeline (tasks/recipes.py over robots/robots.py,
   control/sequences.py, rom/pod.py, sim/fem_surrogate.py and
   models/tpwl_build.py), in f64: (a) examples/diamond_pipeline.py's
   settings (DiamondRobot(n_nodes=10), dt 0.02: POD data, the basis, the
   dictionary, the rollout check, run_scp with the EKF for 5 s, the
   summary) on the card and on the CPU: the same r and selected steps,
   the basis, the dictionary and the rollout within PIPE_F64_TOL, the
   closed loop at the golden test's tolerances; kernel 2 once a rollout
   step, its launches a GuSTO query counted; stage wall times, tracking
   MSE, solve times; (b) the offline half at the Diamond mesh's 1628 nodes
   (a 3,256-entry state) at the recipes' defaults and r = 30: each stage's
   wall time and device-busy share, the plant step, the dictionary's
   size, the peak device memory, the rollout's rel_err; the first 20
   excited plant steps against the f64 CPU run, the basis' orthonormality;
   kernel 2 held to its plain version on its first launch (B=1) and timed;
23. the tet-FEM plant (sim/fem_tet.py, sim/modal.py) and the Diamond tet
   campaign: (a) tests/test_fem_tet.py's box (45 nodes) built on the card
   in f64 and carried to the CPU: 30 steps under seeded inputs with the
   same PCG iterations, a batched step of 4 lanes (one at rest),
   solve_st_multi and both projections at one point, a with_young_scale
   settle, mode_shapes and a short modal_decay_batch, each within
   TET_SMALL_TOL of its scale, and the build's preconditioner operator
   against the CPU's own build; (b) DiamondTetRobot on a box mesh of the
   Diamond's width in its scene (1,584 nodes, a 9,504-dim state; written
   as a .vtu to a temporary directory), built in f64 and f32 (seconds of
   the element stiffnesses, K0, the eigh, the settle), the plant step from
   rest and under 1,500 mN on one cable (the median of 200 steps on the
   host clock, device ms and busy share from a device-only profiled pass,
   PCG iterations), solve_st_multi at 64 columns, the f32 step against the
   f64 one (within TET_F32_TOL), the first 5 loaded steps against the f64
   plant carried to the CPU; then the campaign's --quick
   settings in f64 (examples/diamond_tet_campaign.py:82-85, :124-195: POD
   data, the basis at r = 30, the discrete dictionary at threshold 40,
   the rollout check, run_scp for 3 s on the figure-8): each stage's wall
   time and busy share (a cut, profiled pass), r, P, the rollout's MSE and
   rel_err, the loop's tracking RMSE and plan rejects, kernel 2's launches
   a rollout step and a query, the peak memory; every launch of kernel 2
   in the rollout check and the loop recorded, the first of each shape
   (the rollout's B=1, a query's N states) held to its plain version, and
   both timed;
24. on the same wide f64 robot with phase 23's dictionary (P=146, r=30):
   (a) the four closed-loop recipes of tasks/recipes.py for
   RECIPE_DURATION s on examples/diamond_baselines_campaign.py:86-95's
   figure-8: run_rompc (N=20, N_replan=4, Qz = diag(100, 100, 0), R =
   1e-4 I) and run_koopman (delay 1, degree 2, N=10, rollout_horizon=4,
   16 LHS samples, absolute targets), both condensed through kernel 1
   ('pallas'); run_ilqr (Qz as above, R = 1e-2 I, tf the loop's length,
   iLQRConfig defaults)
   and run_scp_open_loop (N=60, launch.py:122; the target shifted into the
   model's coordinates) through kernel 2. Every launch of kernels 1 and 2
   recorded, the first of each shape and table held to its plain version
   and the most frequent timed; tracking RMSE, ms a tick and a replan (or
   a policy), launches a replan or iteration, the open-loop replay's
   error against its plan; (b) examples/diamond_ssm_campaign.py's --quick
   identification: 4 decays, 4 actuated and 4 held-out runs of the tip's
   [q; v], each one batch of 4 through the batched PCG step (its ms a step
   and the lanes' iterations), learn_ssm (6 states, orders 3 and 3, the
   joint fit, the ridge selected from SSM_RIDGE), both campaign gates
   printed and held finite, save_mat and from_mat(discr_method='be'), and
   BatchSSMMPC condensed at B=1 for SSM_MPC_WINDOWS windows on a figure-8
   about rest (SSM_MPC_SCALE of the decays' tip excursion) in f64, kernel
   1 held at its shape; (c) utils/timing.py's
   block_time on the ROMPC replan's fused step against CUDA events, and
   utils/native.py's library built on the machine (native_available, a
   parse_matrix_txt and SnapLog round trip).
25. scale-out (parallel/mesh.py) on one card, the mesh's devices the card
   given again and again, and the entry points that run on committed
   data: (a) the campaign dictionary split over mp = 2, 4, 8 parts, the
   sharded select (one index-only launch of kernel 2 with its distances
   a part, the least distance winning, ties to the lowest part, each row
   copied from its owner) at B=5120, at B=3072 with index_only=1024 and at
   B=1, f64 and f32: indices and rows identical to the unsharded kernel's;
   the kernel's distance output held to the plain version; the sharded
   select and one part's launch timed beside the unsharded launch;
   (b) sharded_rollout_batch at dp=2 x mp=4 (B=1024, 5 steps, f32): each
   step's indices those of the unsharded kernel, the states those of
   rollout_batch(select='exact') bit for bit; (c) phase 7's loop through
   sharded_batch_mpc_fused_mp at dp=1 x mp=4 (equal to the unsharded run
   bit for bit) and dp=2 x mp=4, and sharded_batch_mpc_fused at dp=4
   (kernel 1 held and timed at the dp part's B=256), the dp runs, as the
   unsharded one, within CPU_AGREE_TOL of the unsharded loop in f64 on the
   card: windows/s and launches a window; dp=2 x mp=4 in f64 at B=16
   against the unsharded f64 CPU run within SCALE_F64_TOL of the scale;
   (d) the launch twin's chain on the surrogate Diamond (run_scp for
   SCALE_SCP_S s), realtime_mpc --campaign diamond for SCALE_RT_SECONDS s
   with its real-time gates, batched_serving at B=1024 with and without
   --mesh 4, the noisy campaign (its gates; its noise-free error within
   NOISY_REL of the committed JAX figure) and the Dubins demo. Phase
   22(a) runs the diamond_pipeline twin.

Every launch count is set to 0 just before a path is driven and read just
after. Each timed kernel row prints the kernel's earlier time on the card
from PERF.md beside this run's. The last three lines of standard output are
the per-kernel JSON
record, the card's name and power limit, and {"ok": true, "device":
{...}}. The full record is also written to build/chip_smoke.json. Without
a card the script exits non-zero before printing any result.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.join(HERE, "tests"))   # tet_box: phase 23's box

from soft_robot_control_tpu_torch.control import batch_mpc  # noqa: E402
from soft_robot_control_tpu_torch.control.batch_mpc import (  # noqa: E402
    BatchMPC, BatchSSMMPC, equilibrate_qp, window_targets)
from soft_robot_control_tpu_torch.control.koopman import (  # noqa: E402
    KoopmanMPC)
from soft_robot_control_tpu_torch.control.linear_mpc import (  # noqa: E402
    LinearMPCService)
from soft_robot_control_tpu_torch.control.mpc import scp  # noqa: E402
from soft_robot_control_tpu_torch.control.policies import (  # noqa: E402
    StateCLQR, StateDLQR, TrajTracking, ilqr)
from soft_robot_control_tpu_torch.control.rompc import ROMPC  # noqa: E402
from soft_robot_control_tpu_torch.control.service import (  # noqa: E402
    GuSTOService)
from soft_robot_control_tpu_torch.core.constraints import (  # noqa: E402
    HyperRectangle)
from soft_robot_control_tpu_torch.core.types import (  # noqa: E402
    QuadraticCost, Target)
from soft_robot_control_tpu_torch.estimators.ekf import (  # noqa: E402
    DiscreteEKFObserver)
from soft_robot_control_tpu_torch.models.dubins import DubinsCar  # noqa: E402,E501
from soft_robot_control_tpu_torch.models.interfaces import (  # noqa: E402
    TPWLGuSTO)
from soft_robot_control_tpu_torch.models.convert import (  # noqa: E402
    model_from_arrays, surrogate_from_arrays, tet_fem_arrays,
    tet_fem_from_arrays, unflatten_arrays)
from soft_robot_control_tpu_torch.models.koopman import (  # noqa: E402
    koopman_model_from_arrays, train_edmd)
from soft_robot_control_tpu_torch.models.linear import (  # noqa: E402
    LinearROM, tpwl_to_linear_rom)
from soft_robot_control_tpu_torch.models.ssm import from_mat  # noqa: E402
from soft_robot_control_tpu_torch.models.tpwl import (  # noqa: E402
    from_tpwl_dict, rollout_batch)
from soft_robot_control_tpu_torch import launch  # noqa: E402
from soft_robot_control_tpu_torch.examples import (  # noqa: E402
    batched_serving, dubins_gusto, noisy_batch_mpc_campaign, realtime_mpc)
from soft_robot_control_tpu_torch.examples import (  # noqa: E402
    diamond_pipeline as pipeline_twin)
from soft_robot_control_tpu_torch.ops import build  # noqa: E402
from soft_robot_control_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402,E501
from soft_robot_control_tpu_torch.parallel.mesh import (  # noqa: E402
    PointShards, make_mesh, sharded_batch_mpc_fused,
    sharded_batch_mpc_fused_mp, sharded_rollout_batch)
from soft_robot_control_tpu_torch.ops.admm_batched import (  # noqa: E402
    admm_batched, admm_batched_plain, admm_cluster, admm_stream,
    cluster_max_active, cluster_plan, cluster_plan_built, stream_max_active,
    stream_plan_built)
from soft_robot_control_tpu_torch.ops.admm_single import (  # noqa: E402
    admm_single, admm_single_plain, prepare_single)
from soft_robot_control_tpu_torch.ops import tpwl_select as select_ops  # noqa: E402,E501
from soft_robot_control_tpu_torch.ops.tpwl_select import (  # noqa: E402
    point_distances_batch, tpwl_select, tpwl_select_plain)
from soft_robot_control_tpu_torch.qp.blocked import make_kinv  # noqa: E402
from soft_robot_control_tpu_torch.robots import DiamondRobot  # noqa: E402
from soft_robot_control_tpu_torch.rom.pod import POD  # noqa: E402
from soft_robot_control_tpu_torch.robots.robots import (  # noqa: E402
    DiamondTetRobot)
from soft_robot_control_tpu_torch.scp.locp import LOCPParams  # noqa: E402
from soft_robot_control_tpu_torch.scp import gusto_jit  # noqa: E402
from soft_robot_control_tpu_torch.scp import gusto as gusto_mod  # noqa: E402,E501
from soft_robot_control_tpu_torch.scp.gusto_jit import GuSTOJit  # noqa: E402
from soft_robot_control_tpu_torch.scp.locp_condensed import (  # noqa: E402
    CondensedParams)
from soft_robot_control_tpu_torch.scp.locp_stages import (  # noqa: E402
    StageLOCP, StageLOCPAdapter)
from soft_robot_control_tpu_torch.scp.standalone import (  # noqa: E402
    run_gusto_standalone)
from soft_robot_control_tpu_torch.sim.closed_loop import (  # noqa: E402
    run_closed_loop)
from soft_robot_control_tpu_torch.sim import fem_tet  # noqa: E402
from soft_robot_control_tpu_torch.sim.fem_surrogate import (  # noqa: E402
    simulate)
from soft_robot_control_tpu_torch.sim.fem_tet import (  # noqa: E402
    make_box_mesh, with_young_scale, write_vtu_ascii)
from soft_robot_control_tpu_torch.sim.modal import (  # noqa: E402
    modal_decay_batch, mode_shapes)
from soft_robot_control_tpu_torch.sim.measurement import (  # noqa: E402
    linearModel)
from soft_robot_control_tpu_torch.tasks import recipes  # noqa: E402
from soft_robot_control_tpu_torch.utils.device import to_numpy  # noqa: E402
from tet_box import box_plant  # noqa: E402

ARTIFACT = os.path.join(HERE, "examples", "diamond_tet",
                        "tpwl_model_snapshots.pkl")
SSM_ARTIFACTS = {
    "trunk": os.path.join(HERE, "examples", "trunk_tet",
                          "trunk_SSM_model.mat"),
    "diamond": os.path.join(HERE, "examples", "diamond_tet",
                            "diamond_SSM_model.mat")}
KERNELS = ("admm_batched", "tpwl_select", "admm_stream", "admm_cluster",
           "admm_single")
WRAPPERS = {"admm_batched": admm_batched, "tpwl_select": tpwl_select,
            "admm_stream": admm_stream, "admm_cluster": admm_cluster,
            "admm_single": admm_single}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOP_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
#                             (and float64 on its FP64 tensor cores)
QUALITY_GATE = 0.05         # bench.py's rel tracking error gate
ADMM_F64_TOL = 1e-9         # max abs error, kernel vs plain, f64
ADMM_F32_TOL = 1e-4         # max abs error over max(|w|, |y|, 1), f32
CPU_AGREE_TOL = 1e-4        # rel z difference, f32 card vs f64 CPU loop
# The sparse QP keeps the dynamics as equality rows with a 1e3 rho boost,
# and K^-1 of that KKT amplifies f32 rounding: in the kernels' sums, which
# run in another order than the plain version's (measured on an H100: up to
# 3.7e-4 of the solution's scale for kernel 3, 5e-5 for kernel 4), and, in
# the loops, in the library factorizations around them alike (measured f32
# card against f64 CPU: 4.4e-3 on path A, 2.1e-2 on path B, whose
# R = 1e-3 I keeps the output's own variation, the denominator, small).
# The f64 card runs of the same loops are therefore held to the f64 CPU
# runs too, at F64_CPU_AGREE_TOL: that comparison is the one that would
# show a kernel at fault inside a loop.
SPARSE_F32_TOL = 1e-3
PATH_A_CPU_AGREE_TOL = 1e-2
PATH_B_CPU_AGREE_TOL = 5e-2
F64_CPU_AGREE_TOL = 1e-6    # rel z difference, f64 card vs f64 CPU loop
NEAR_TIE = 1e-6             # f64 relative gap under which indices may differ
N, N_REPLAN, N_WIN, B_MAIN, B_CPU = 5, 2, 4, 1024, 8
N_F64_CLUSTER = 3           # horizon whose f64 sparse QP fits a cluster
N_WIN_B = 10                # windows of the single-trajectory path
ITERS = 100 // 4            # ADMM iterations per launch (100 in 4 stages)
ITERS_B = 50                # iterations of the single-QP launch
GUSTO_B = 64                # batch of the fused GuSTO paths and their check
GUSTO_ITERS, GUSTO_QP_ITERS = 5, 50  # SCP iterations; ADMM iterations each
RT_QUERIES = 4              # MPC queries of the real-time GuSTO path
# ADMM iterations of its QPs (4 rho stages): at the default 400 the trust-
# region slack's s >= 0 row is still violated when the residual gate reads
# it, and the loop spends its 30 iterations re-solving the first QP
RT_QP_ITERS = 1000
# the streaming kernel's square f64 QP at the earlier one-block design's
# end (phase 5): beyond the full-slot plan, within the windowed one
STREAM_OLD_END = 2641
LTI_N, LTI_STEPS = 20, 3    # LTI service horizon; steps held to the CPU
# GuSTO's sparse LOCP (1e3 rho on 360 equality rows, a trust region, 50
# iterations) amplifies f32 rounding more than path A's: the streaming
# kernel against the plain version in f32, 4.9e-3 of the solution's scale
# (measured on an H100 80GB HBM3; in f64 8e-12 of it)
GUSTO_SPARSE_KERNEL_F32_TOL = 1e-2
# That limit admits the formulation's rounding; the kernel's own is bounded
# apart: its f32 result's error against the plain version in f64 on the
# same inputs, over the plain f32 result's error, measured on an H100 80GB
# HBM3 at 1.40 (sparse) and 4.08 (condensed) with the earlier designs,
# whose lanes summed the 641 rows of A^T t in one serial walk where the
# library sums in blocks, and at 0.88 and 0.67 with the streaming kernel
# on clusters and kernel 1's block form (row groups, the x-step in f64)
GUSTO_F32_ROUNDING_RATIO = {"condensed": 8.0, "sparse": 2.0}
# f32 card runs of the GuSTO and LTI paths against the f64 CPU run: x and u,
# max abs difference over max(|x|, 1) resp. max(|u|, 1). Measured on an
# H100 80GB HBM3, the same in two runs: 3.8e-5 (GuSTO condensed), 2.5e-2
# (GuSTO sparse: the f32 rounding above, in the kernel and the K^-1 builds
# alike), 4.7e-7 (real-time), 7.5e-7 (LTI, either backend).
GUSTO_F32_TOL = 4e-4
GUSTO_SPARSE_F32_TOL = 1e-1
GUSTO_RT_F32_TOL = 5e-6
LTI_F32_TOL = 1e-5
# BatchSSMMPC (phase 14): bench.py section 5's settings
SSM_N, SSM_N_REPLAN, SSM_DT, SSM_QP_ITERS = 3, 2, 0.02, 50
SSM_N_WIN, SSM_B, SSM_B_DIAMOND = 4, 1024, 64
# f32 card logs against the f64 CPU run: max abs difference of the outputs
# about z_ref and of the commands, over the reference's max abs. The
# trunk's outputs move a few um about z_ref ~ 196 mm, some 250 f32 ulps of
# it, and the Diamond's sparse LOCP carries the 1e3 equality rho: the port's
# f32 run on the CPU against its f64 run reads 6.2e-3 (trunk, both
# formulations), 5.9e-4 (Diamond condensed) and 5.0e-2 (Diamond sparse)
SSM_F32_TOL = {"condensed": 2e-2, "sparse": 1.5e-1}
# Kernel 1 in f32 on these LOCPs: its error against the plain version in
# f64 on the same inputs within SSM_F32_ROUNDING_RATIO x the plain f32
# version's (measured on an H100 80GB HBM3 at 0.53-1.98 over both
# artifacts, formulations and B = 1, 3, 1024 with the earlier warp-per-QP
# form; 2.03 on the Diamond's sparse LOCPs with the block form summing its
# x-step in f32, and 0.03-0.70 on the sparse LOCPs with that step in f64,
# as it now is), and its difference from the
# plain f32 version within the larger of the raw limit (1e-4 / 1e-3 of the
# solution's scale) and twice the plain version's own f32 error: the
# Diamond's LOCPs (K^-1 entries to 1.8e5 with R = 1e-6 I) put the plain
# version's own f32 error at 0.9-1.4x the raw limit, so no other summation
# order can meet the raw limit there
SSM_F32_ROUNDING_RATIO = 2.0
# Earlier card times of the batched ADMM kernels at the paths' shapes
# (PERF.md section 6's kernel table, H100 80GB HBM3, 700 W), printed beside this run's: (kernel, B, n, m, iterations, element
# bytes) -> (row, ms)
EARLIER_MS = {
    ("admm_batched", 1024, 20, 40, 25, 4): ("1", 0.0197),
    ("admm_batched", 64, 21, 641, 50, 4): ("1b", 0.1515),
    ("admm_batched", 1, 80, 160, 37, 4): ("1c", 0.1162),
    ("admm_batched", 1024, 24, 1, 50, 4): ("1d", 0.0354),
    ("admm_batched", 1024, 48, 24, 50, 4): ("1e", 0.1254),
    ("admm_batched", 1, 80, 1, 37, 4): ("1f", 0.0789),
    ("admm_batched", 1, 40, 152, 100, 4): ("1g", 0.2089),
    ("admm_cluster", 1024, 380, 400, 25, 4): ("3", 6.6630),
    ("admm_stream", 1024, 380, 400, 25, 4): ("3b", 8.6404),
    ("admm_stream", 1024, 380, 400, 25, 8): ("3b f64", 16.1219),
    ("admm_stream", 64, 386, 1126, 50, 4): ("3c", 3.4413),
    ("admm_stream", 64, 386, 1126, 50, 8): ("3c f64", 7.3987),
    ("admm_single", 1, 380, 400, 50, 4): ("4", 0.2618)}
# The stage LOCP (phase 15): bench.py section 4b's settings
STAGE_N, STAGE_ITERS, STAGE_RUNS = 200, 100, 3
# f32 against f64 there, w over its scale: cyclic reduction's explicit
# block inverses lose what the 1e3 equality rho amplifies, and so do the
# JAX package's in f32 (tests/test_torch_locp_stages.py holds the port's
# f32 error within 2x of JAX's). Measured on an H100 80GB HBM3 after 100
# iterations: 'cr' 0.1346, 'scan' 0.0079; 'cr' against 'scan' in f64 on
# the CPU 7.3e-10
STAGE_F32_TOL = {"cr": 0.5, "scan": 0.05}
STAGE_CR_SCAN_F64_TOL = 1e-8
# GuSTO's stage backend on the campaign dictionary (phase 16): ADMM
# iterations an LOCP. The stage adapter accepts a solve at absolute
# residuals pri < 1e-4, dua < 1e-3 (the JAX package's gate); at 6000 the
# f64 loop takes 4 accepted solves of 5 at N=200 (measured on an H100
# 80GB HBM3); the default 400 and 2000 missed it in a CPU rehearsal
STAGE_GUSTO_ADMM_ITERS = 6000
# ... and its SCP iterations, cut in depth: GuSTO's first solve runs up to
# scp/gusto.py:MAX_ITERS + 1 of them (5 LOCP solves on the card at full
# depth, each of STAGE_GUSTO_ADMM_ITERS at N=200, about 23 s), which the
# campaign's two runs patch to this many; the first LOCP, the one held to
# the CPU, and kernel 2's launches of the rollout, the linearization and
# the accuracy ratio come first
STAGE_GUSTO_SCP_ITERS = 1
# the Dubins car's f32 plan against the f64 CPU run where their solves
# match (measured on an H100 80GB HBM3: 5.9e-5)
STAGE_GUSTO_F32_TOL = 1e-3
# ROMPC and Koopman MPC (phases 17-18): the campaign's horizons, the delay
# cut from 1 s to 2 ticks, 18 ticks (4 replans); the EDMD data of 60 held
# inputs (the campaign's --koopman-samples)
BASELINE_N_ROMPC, KOOPMAN_N, KOOPMAN_SAMPLES = 20, 10, 60
BASELINE_DELAY, BASELINE_TICKS = 0.02, 18
BASELINE_F32_TOL = 1e-3
# The golden chain loop (phase 19): tests/golden/ fixtures written by the
# JAX package, held at tests/test_golden.py's (rtol, atol)
CHAIN_FIXTURE = os.path.join(HERE, "tests", "golden",
                             "chain_pipeline_arrays.npz")
GOLDEN_CHAIN = os.path.join(HERE, "tests", "golden", "closed_loop_chain.npz")
GOLDEN_DT = 0.02
GOLDEN_Z_TOL, GOLDEN_U_TOL = (1e-6, 1e-9), (1e-5, 1e-8)
# The campaign's closed loops (phases 20-21): examples/diamond_tet_
# campaign.py:158-190's real-time MPC at its N=10, the delay cut from 1 s
# to 2 ticks, then 20 ticks (10 for each other policy). GuSTO's polish
# step is off: it guesses the active set from the signs of duals that are
# rounding noise at R = 1e-5 I, so two runtimes (the card and the CPU; the
# port and the JAX package) can take different plans from one query on,
# which the DARE gains (about sqrt(Qz / R)) amplify (ROADMAP.md section 3)
CAMPAIGN_DT, CAMPAIGN_N, CAMPAIGN_DELAY = 0.01, 10, 0.02
CAMPAIGN_TICKS, POLICY_TICKS, ILQR_STEPS = 20, 10, 20
CAMPAIGN_GUSTO = dict(max_gusto_iters=0, convg_thresh=1e-2,
                      is_tr_active=False, locp_backend="condensed",
                      oneshot_iters=2, plan_bound=60.0, polish=False)
# f32 card loop against the f64 CPU loop, z and u over their scale:
# measured on an H100 80GB HBM3 at 3.7e-3 (2.8e-3 in a CPU rehearsal; the
# f32 DARE gains at R = 1e-5 I read 2.7e-6 of their scale from f64)
CAMPAIGN_F32_TOL = 2e-2
# The Diamond pipeline (phase 22): examples/diamond_pipeline.py's settings
# (a), then the offline half at the Diamond mesh's 1628 nodes (b), whose
# state has 3,256 entries (robots/environments.py:144's mesh; the dense
# Jacobian of a step is 85 MB in f64), at the recipes' defaults and the
# campaign's r = 30. Its artifacts go under build/pipeline.
PIPE_DIR = os.path.join(HERE, "build", "pipeline")
PIPE_WIDE_NODES = 1628
PIPE_WIDE_R = 30
# (a) f64 card run against the f64 CPU run: snapshots, the POD basis (up to
# each column's sign), the dictionary's points and matrices and the
# rollout's z within this fraction of their scale (the same f64 arithmetic
# summed in other orders; the port's f64 CPU run against the JAX package
# reads 8e-13 on the basis, tests/test_torch_recipes.py); the closed loop
# at the golden test's tolerances (GOLDEN_Z_TOL, GOLDEN_U_TOL)
PIPE_F64_TOL = 1e-9
# (b) the first steps of the wide sweep after the excitation starts, on the
# card against the port's f64 CPU run, and the basis' orthonormality
PIPE_WIDE_STEPS = 20
PIPE_WIDE_TOL = 1e-9
PIPE_ORTHO_TOL = 1e-10
# LHS samples of (b)'s profiled pass (the timed pass runs the defaults)
PIPE_PROFILE_SAMPLES = 4
# The tet-FEM plant (phase 23). (a) tests/test_fem_tet.py:51-61's box in
# f64 on the card against the CPU (the card's plant carried to the CPU
# with models/convert.py), each quantity within TET_SMALL_TOL of its
# scale: the same f64 arithmetic, the card's scatter summing in another
# order. (b) a box mesh of the Diamond's width in its scene:
# make_box_mesh(11, 12, 12, spacing=10) shifted by -TET_SHIFT, 1,584 nodes
# (a 9,504-dim state), written as a .vtu and built by DiamondTetRobot;
# the first TET_WIDE_STEPS steps under TET_LOAD mN on one cable against
# the f64 plant carried to the CPU; then examples/diamond_tet_campaign.py's
# --quick settings (TET_CAMPAIGN) in f64, artifacts under build/tet_campaign
TET_SMALL_TOL = 1e-9
TET_SMALL_STEPS = 30
TET_BOX, TET_SHIFT = (11, 12, 12), (50.0, 35.0, 55.0)
TET_LOAD = 1500.0
TET_WIDE_STEPS = 5
TET_WIDE_TOL = 1e-9
# the f32 step against the f64 step at the loaded state, of the state's
# scale: PCG's tolerance is 1e-6 and the card read 8.2e-6 (PR 12); a lost
# mask or a wrong cast reads O(1)
TET_F32_TOL = 1e-4
TET_TIMED_STEPS = 200      # plant steps timed from one state, one by one
TET_PROFILED_STEPS = 10    # of them once more under the profiler
TET_LOAD_STEPS = 20        # steps under load before the loaded step
TET_COLUMNS = 64           # solve_st_multi's 2r + m at r = 30, m = 4
TET_DIR = os.path.join(HERE, "build", "tet_campaign")
TET_CAMPAIGN = dict(samples=8, t_step=0.25, pod_tol=5e-5, rom_dim=30,
                    threshold=40.0, check_samples=6, check_seed=333,
                    sim_duration=3.0, delay=1.0, N=10, N_replan=2)
# LHS samples (and run_scp seconds: the 1 s delay, then 3 queries) of the
# profiled pass of each stage
TET_PROFILE_SAMPLES, TET_PROFILE_SCP_S = 1, 1.06
# Phase 24: the closed-loop recipes on the box of the Diamond's width with
# phase 23's dictionary, at examples/diamond_baselines_campaign.py's
# --quick settings (seconds of closed loop, the delay), and the Diamond SSM
# campaign's --quick identification (examples/diamond_ssm_campaign.py:
# 110-150: 4 decays at 900 mN, hold 1.5 s, decay 2.5 s, the first 5 decay
# samples dropped, 4 ridge candidates); BatchSSMMPC on the learned model at
# phase 14's settings, B=1, for SSM_MPC_WINDOWS windows; block_time timed
# UTIL_REPS times against CUDA events
RECIPE_DURATION, RECIPE_DELAY = 3.0, 1.0
SSM_AMP, SSM_HOLD, SSM_DECAY, SSM_SKIP = 900.0, 1.5, 2.5, 5
SSM_RIDGE = (1e-8, 1e-6, 1e-4, 1e-2)
SSM_MPC_WINDOWS, UTIL_REPS = 4, 20
# block_time's wall ms may fall short of the CUDA events' ms of the same
# call by no more than the events' resolution (about 0.5 us)
BLOCK_TIME_SLACK_MS = 0.01
# Phase 25: the parts of the dictionary the sharded select runs on; the
# kernel's distance to its point against the plain version's (torch.cdist),
# relative: each sums r squared differences in its own order
SCALE_MP = (2, 4, 8)
SELECT_DIST_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
# states of the sharded rollout; batch of the f64 sharded loop, whose z and
# u must stay within this fraction of their scale of the unsharded f64 CPU
# run's (the same f64 arithmetic, summed in other orders on the card)
SCALE_ROLL_B, SCALE_F64_B, SCALE_F64_TOL = 1024, 16, 1e-10
# seconds of the launch twin's run_scp and of the real-time loop; the
# noisy campaign's noise-free error against the committed JAX figure,
# relative (its f32 run on a TPU; the port's on the card)
SCALE_SCP_S, SCALE_RT_SECONDS, NOISY_REL = 1.5, 2.0, 0.1
# the MPC's figure-8 about rest, in x and y, as a fraction of the decays'
# largest tip excursion: the campaign's 15 mm figure-8 is for the Diamond
# mesh, and 900 mN move this stiffer stand-in's tip about 0.5 mm, beyond
# which the learned polynomials extrapolate
SSM_MPC_SCALE = 0.5


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() over `reps` back-to-back calls. A sleep
    kernel queued first keeps the stream busy while the host enqueues the
    calls, so host overhead between launches is not counted."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # ~0.2 s of device cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clocks():
    """The card's SM clock, its maximum, power draw and temperature now, as
    nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


def earlier(kernel, B, n, m, iters, ms, elem=4):
    """Print the PERF.md row of a kernel launch's shape and element size
    beside this run's time, where PERF.md has one. Only printed: the record
    holds what this run measured."""
    row = EARLIER_MS.get((kernel, B, n, m, iters, elem))
    if row is not None:
        print(f"[{kernel}] B={B} n={n} m={m} {iters} iters, {8 * elem}-bit: "
              f"{ms:.4f} ms, earlier {row[1]} ms (PERF.md row {row[0]}, "
              f"{row[1] / ms:.4f}x)")


def bound(bytes_moved, flops):
    """Least time (ms) for the work on an H100, and what sets it."""
    t_b = bytes_moved / HBM_BYTES_PER_S
    t_f = flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts():
    return {name: w.launches for name, w in WRAPPERS.items()}


def make_mpc(model, dtype, device, path="condensed", horizon=N):
    """BatchMPC at bench.py's settings: 'condensed' and 'A' (sparse) are
    the quality-gated fused loops, 'B' the single-trajectory sparse loop
    through the single-QP kernel."""
    nz, m_in = model.H.shape[0], model.input_dim
    kw = dict(N=horizon, dt=0.01, N_replan=N_REPLAN, scp_iters=1, dtype=dtype,
              U=HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in)),
              W=1e-2 * np.eye(model.state_dim),
              V=1e-4 * np.eye(model.C.shape[0]), device=device)
    if path == "B":
        return BatchMPC(model, 100.0 * np.eye(nz), 1e-3 * np.eye(m_in),
                        qp_iters=ITERS_B, use_pallas=True, **kw)
    return BatchMPC(
        model, 100.0 * np.eye(nz), 1e-5 * np.eye(m_in), qp_iters=100,
        x_step="kinv", rho_stages=4, scaling_iters=6,
        formulation="condensed" if path == "condensed" else "sparse", **kw)


def feasible_targets(model, B, n_win):
    """bench.py's quality targets: the model's own z-response to smooth
    admissible cable inputs, windowed (B, n_win, N+1, n_z)."""
    T_q = n_win * N_REPLAN + N + 1
    zq = feasible_outputs(model, B, T_q + 1)
    return np.stack([window_targets(zq[b, :T_q], n_win, N_REPLAN, N)
                     for b in range(B)])


def feasible_outputs(model, B, T):
    """The model's own output z (B, T, n_z) under smooth admissible cable
    inputs from the zero state: targets it can track."""
    dt = model.pre_discretized_dt
    rng = np.random.default_rng(11)
    tq = dt * np.arange(T)
    u_ref = 0.5 * 1500.0 * (1.0 + np.sin(
        2 * np.pi * tq[None, :, None] / 4.0
        + rng.uniform(0, 2 * np.pi, size=(B, 1, model.input_dim))))
    x0 = torch.zeros((B, model.state_dim), dtype=model.q.dtype,
                     device=model.device)
    X = rollout_batch(model, x0, torch.as_tensor(
        u_ref, dtype=model.q.dtype, device=model.device), dt)
    return (X @ model.H.T + model.z_ref).cpu().numpy()[:, :T]


def rel_track(z, zt):
    """bench.py's relative tracking error of logged z (B, T, n_z) against
    the executed target entries 1..N_replan of each window of zt."""
    B, n_win = zt.shape[:2]
    zt_exec = zt[:, :, 1:N_REPLAN + 1, :].reshape(B, n_win * N_REPLAN, -1)
    den = max(np.linalg.norm(zt_exec - zt_exec.mean(axis=(0, 1))), 1e-12)
    return float(np.linalg.norm(z - zt_exec) / den)


def window_qps(mpc, x, zt):
    """The first window's QPs (P, q, A, l, u, w0, y0) as mpc's loop builds
    them: linearized at the states x (B, n_x), assembled with mpc's spec
    over mpc's horizon, Ruiz-equilibrated, with a cold start."""
    B, N = x.shape[0], mpc.N
    x_plan = x[:, None].expand(-1, N + 1, -1)
    Ad, Bd, dd = mpc._gather_traj(x_plan)
    z = torch.as_tensor(zt[:, :N + 1], dtype=x.dtype,
                        device=x.device) - mpc.model.z_ref
    zeros = lambda *shape: torch.zeros((B,) + shape, dtype=x.dtype,
                                       device=x.device)
    if mpc.formulation == "condensed":
        qp = mpc.cspec.assemble(CondensedParams(
            Ad=Ad, Bd=Bd, dd=dd, x0=x, z=z, u_des=zeros(N, mpc.n_u)))[:5]
    else:
        qp = mpc.spec.assemble(LOCPParams(
            Ad=Ad, Bd=Bd, dd=dd, x0=x, xk=x_plan, delta=mpc.delta0,
            omega=mpc.omega0, z=z, zf=zeros(mpc.n_z),
            u_des=zeros(N, mpc.n_u)))[:5]
    n_var, n_con = mpc._qp_dims()
    return equilibrate_qp(*qp, zeros(n_var), zeros(n_con),
                          mpc.scaling_iters)[:7]


def admm_inputs(mpc, x, zt):
    """Stage-0 inputs of the batched ADMM kernels as the fused loop builds
    them: rho folded into the rows, K^-1 from make_kinv."""
    P, q, A, l, u, w0, y0 = window_qps(mpc, x, zt)
    rho = mpc.rho_vec_c if mpc.formulation == "condensed" else mpc.rho_vec
    srt = torch.sqrt(rho)
    ones = torch.ones_like(srt)
    As = A * srt[None, :, None]
    return [make_kinv(P, As, ones), As, q, srt * l, srt * u, ones, w0,
            y0 / srt]


def compare(name, tag, got, ref, dtype, tol_f32, f64_scaled=False):
    """Max abs error of a kernel's (w, y) against its plain version's;
    fails beyond 1e-9 (f64; times the solution's scale where `f64_scaled`,
    for the sparse QPs, whose duals reach 1e4) or tol_f32 times the
    solution's scale (f32)."""
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(max(float(b.abs().max()) for b in ref), 1.0)
    print(f"[{name}] {tag}: max abs err {err:.3e} (solution scale "
          f"{scale:.3e})")
    check(all(bool(torch.isfinite(a).all()) for a in got),
          f"{name} {tag}: non-finite output")
    if dtype == torch.float64:
        tol = ADMM_F64_TOL * (scale if f64_scaled else 1.0)
    else:
        tol = tol_f32 * scale
    check(err <= tol, f"{name} {tag}: error {err} > {tol}")
    return {"max_abs_err": err, "scale": scale}


def random_qps(B, n, m, seed, dtype, device):
    """B random feasible QPs of n variables and m rows with K^-1 from
    make_kinv (built in f64), a shared rho row, and infinite bounds on the
    first m // 8 rows (no lower) and the next m // 8 (no upper); the
    kernels' argument list."""
    rng = np.random.default_rng(seed)
    Ph = torch.as_tensor(rng.normal(size=(B, n, n)), device=device)
    P = Ph @ Ph.transpose(1, 2) + 0.1 * torch.eye(
        n, dtype=torch.float64, device=device)
    A = torch.as_tensor(rng.normal(size=(B, m, n)), device=device)
    mid = torch.einsum("bmn,bn->bm", A, torch.as_tensor(
        0.2 * rng.normal(size=(B, n)), device=device))
    rho = torch.full((m,), 0.1, dtype=torch.float64, device=device)
    half = torch.as_tensor(rng.uniform(0.1, 1, (2, B, m)), device=device)
    l, u = mid - half[0], mid + half[1]
    l[:, :m // 8] = -float("inf")
    u[:, m // 8:2 * (m // 8)] = float("inf")
    args = [make_kinv(P, A, rho), A, torch.as_tensor(
        rng.normal(size=(B, n)), device=device), l, u, rho,
        torch.as_tensor(0.1 * rng.normal(size=(B, n)), device=device),
        torch.as_tensor(0.1 * rng.normal(size=(B, m)), device=device)]
    return [t.to(dtype) for t in args]


def check_sizes(wrapper, args, sizes, tag, tol_f32, f64_scaled, out):
    """wrapper against admm_batched_plain on the first B QPs of args, for B
    in `sizes`; each result goes into out under `tag` B=..."""
    name = wrapper.__name__
    for B in sizes:
        a = [t[:B] if t.dim() > 1 else t for t in args]
        count = wrapper.launches
        got = wrapper(*a, ITERS)
        check(wrapper.launches == count + 1,
              f"{name} did not launch its kernel")
        key = f"{tag} B={B}"
        out[key] = compare(name, key, got, admm_batched_plain(*a, ITERS),
                           args[0].dtype, tol_f32, f64_scaled=f64_scaled)


def admm_work(B, n, mc, iters):
    """Bytes (inputs read once, outputs written once, f32) and operations
    (per iteration three mat-vecs, A^T, K^-1, A, and the element-wise
    updates) of B fixed-iteration ADMM solves."""
    nbytes = 4 * (B * n * n + B * mc * n + 3 * B * n + 4 * B * mc + mc)
    flops = B * (2 * mc * n + 2 * mc + iters * (
        4 * mc * n + 2 * n * n + 5 * n + 12 * mc))
    return nbytes, flops


def phase_admm(wrapper, mpc64, mpc, x_qp, zt, card, sizes, tol_f32, reps,
               cluster_sizes=(), other_size=None, time_f64=False):
    """A batched ADMM kernel against admm_batched_plain at the batch sizes
    `sizes`, f64 (on mpc64's QPs) and f32 (on mpc's), then timed at B_MAIN
    in f32, also with no iterations, and (`time_f64`) in f64 on the same
    QPs; `other_size` (n, m) repeats the checks and the timing on random
    QPs of that size; `cluster_sizes` are also timed, in turns, where the
    wrapper takes a cluster size."""
    name = wrapper.__name__
    out = {}
    for m in (mpc64, mpc):
        B_in = B_MAIN if m is mpc else max(sizes)
        args = admm_inputs(m, x_qp[:B_in].to(m.dtype), zt[:B_in, 0])
        n_inf = int(torch.isinf(args[3][0]).sum()
                    + torch.isinf(args[4][0]).sum())
        print(f"[{name}] {str(m.dtype)[6:]} QPs of n={args[2].shape[1]}, "
              f"m={args[3].shape[1]} with {n_inf} infinite bounds each")
        check_sizes(wrapper, args, sizes, str(m.dtype)[6:], tol_f32,
                    m.formulation == "sparse", out)
    B, n, mc = B_MAIN, args[2].shape[1], args[3].shape[1]
    ms = cuda_ms(lambda: wrapper(*args, ITERS), reps)
    ms0 = cuda_ms(lambda: wrapper(*args, 0), reps)
    out["clocks"] = clocks()
    plain_ms = cuda_ms(lambda: admm_batched_plain(*args, ITERS), 3)
    nbytes, flops = admm_work(B, n, mc, ITERS)
    bound_ms, bound_by = bound(nbytes, flops)
    us_iter = 1e3 * (ms - ms0) / ITERS
    out.update(ms=ms, ms_no_iterations=ms0, us_per_iteration=us_iter,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops,
               shape=f"B={B}, n={n}, m={mc}, iters={ITERS}, f32")
    print(f"[{name}] f32 B={B} n={n} m={mc} {ITERS} iters: kernel "
          f"{ms:.4f} ms ({ms0:.4f} ms with no iteration: {us_iter:.3f} us "
          f"an iteration), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}; after it SM clock, max, power, temperature: "
          f"{out['clocks']}]")
    earlier(name, B, n, mc, ITERS, ms)
    if time_f64:
        a64 = [t.double() for t in args]
        out["ms_f64"] = cuda_ms(lambda: wrapper(*a64, ITERS), reps)
        print(f"[{name}] f64 B={B} n={n} m={mc} {ITERS} iters: kernel "
              f"{out['ms_f64']:.4f} ms [{card}]")
        earlier(name, B, n, mc, ITERS, out["ms_f64"], elem=8)
        del a64
    if other_size is not None:
        n2, m2 = other_size
        for dt in (torch.float64, torch.float32):
            a2 = random_qps(max(sizes), n2, m2, 17, dt, mpc.device)
            check_sizes(wrapper, a2, sizes, f"{str(dt)[6:]} n={n2} m={m2}",
                        tol_f32, False, out)
        ms2 = cuda_ms(lambda: wrapper(*a2, ITERS), reps)
        ms20 = cuda_ms(lambda: wrapper(*a2, 0), reps)
        b2, f2 = admm_work(B, n2, m2, ITERS)
        bound2, by2 = bound(b2, f2)
        out[f"n={n2} m={m2}"] = dict(ms=ms2, ms_no_iterations=ms20,
                                    bound_ms=bound2, bound_by=by2)
        print(f"[{name}] f32 B={B} n={n2} m={m2} {ITERS} iters: kernel "
              f"{ms2:.4f} ms ({ms20:.4f} ms with no iteration), bound "
              f"{bound2:.5f} ms ({by2}) [{card}]")
    if cluster_sizes:
        plan = cluster_plan_built(n, mc, 4)
        print(f"[{name}] default plan at n={n}, m={mc}, f32: {plan}")
        out["plan"] = plan
        out["by_cluster_size"] = {}
        turns = tuple(cluster_sizes) + tuple(reversed(cluster_sizes))
        for R in turns:
            t = cuda_ms(lambda: wrapper(*args, ITERS, cluster_size=R), reps)
            by = out["by_cluster_size"].setdefault(R, {
                "max_active_clusters": cluster_max_active(n, mc, 4, R),
                "block_bytes": cluster_plan_built(n, mc, 4, R)[
                    "block_bytes"], "ms": []})
            by["ms"].append(t)
        for R, by in out["by_cluster_size"].items():
            waves = -(-B // by["max_active_clusters"])
            print(f"[{name}] clusters of {R}: {by['block_bytes']} bytes a "
                  f"block, {by['max_active_clusters']} clusters (QPs) in "
                  f"flight, {waves} waves at B={B}; "
                  f"{' / '.join(f'{t:.4f}' for t in by['ms'])} ms [{card}]")
    return out


def stream_plans():
    """The streaming kernel's plan at its paths' shapes (GuSTO sparse in f32
    and f64, path A in f64) and the clusters (QPs) the card holds at once."""
    out = {}
    for n, m, elem in ((386, 1126, 4), (386, 1126, 8), (380, 400, 8)):
        plan, active = stream_plan_built(n, m, elem), stream_max_active(
            n, m, elem)
        print(f"[admm_stream] n={n} m={m} {8 * elem}-bit: {active} clusters "
              f"in flight; plan {plan}")
        out[f"n={n} m={m} elem={elem}"] = dict(plan=plan, max_active=active)
    return out


def stream_end(elem, built):
    """The largest n of a square QP that has a streaming plan, by bisection
    over `built(n, n, elem)` (None where none fits)."""
    lo, hi = 386, 20000
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if built(mid, mid, elem) is not None else (
            lo, mid - 1)
    return lo


def stream_range(card, dev):
    """The streaming kernel's range: the ends of its plan for square QPs
    in f32 and f64 as the built source exports them, against the Python
    plan; the f64 QP at n = m = STREAM_OLD_END (the earlier one-block
    design's end, which the full-slot plan refused) held to its plain
    version within ADMM_F64_TOL of the solution's scale."""
    out = {}
    for elem in (4, 8):
        end = stream_end(elem, stream_plan_built)
        want = stream_end(elem, lambda n, m, e: cluster_plan(
            n, m, e, stream=True))
        check(end == want, f"admm_stream: the built plan ends at {end} in "
              f"{8 * elem}-bit, the Python plan at {want}")
        plan = stream_plan_built(end, end, elem)
        print(f"[admm_stream] square QPs up to n = m = {end} in {8 * elem}-"
              f"bit (full slots: {1842 if elem == 8 else 3684}); plan there "
              f"{plan}")
        out[f"end_{8 * elem}bit"] = end
    n = STREAM_OLD_END
    args = random_qps(1, n, n, 23, torch.float64, dev)
    count = admm_stream.launches
    got = admm_stream(*args, ITERS)
    check(admm_stream.launches == count + 1,
          "admm_stream did not launch at the old end")
    ref = admm_batched_plain(*args, ITERS)
    torch.cuda.synchronize()
    scale = max(max(float(r.abs().max()) for r in ref), 1.0)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    ms = cuda_ms(lambda: admm_stream(*args, ITERS), 3)
    plan = stream_plan_built(n, n, 8)
    print(f"[admm_stream] f64 B=1 n=m={n} {ITERS} iters (x~ in windows: "
          f"{plan['x_window']}): max abs difference from the plain version "
          f"{err:.3e} of scale {scale:.3e} (limit {ADMM_F64_TOL} of the "
          f"scale); kernel {ms:.4f} ms [{card}]")
    check(err <= ADMM_F64_TOL * scale, f"admm_stream at n = m = {n}: {err}")
    out[f"f64 n=m={n}"] = dict(max_abs_err=err, scale=scale, ms=ms,
                               plan=plan)
    return out


def phase_single(mpc64, mpc, x_qp, zt, card):
    """The single-QP kernel against admm_single_plain on one sparse QP
    prepared as admm_fixed_single prepares it, f64 and f32, then timed."""
    out = {}
    for m in (mpc64, mpc):
        P, q, A, l, u, w0, y0 = (t[0] for t in window_qps(
            m, x_qp[:1].to(m.dtype), zt[:1, 0]))
        M1, l_f, u_f = prepare_single(P, A, l, u, m.rho_vec)
        args = [M1, A, q, l_f, u_f, m.rho_vec, w0, y0]
        count = admm_single.launches
        got = admm_single(*args, ITERS_B)
        check(admm_single.launches == count + 1,
              "admm_single did not launch its kernel")
        tag = str(m.dtype)[6:]
        out[tag] = compare("admm_single", tag, got,
                           admm_single_plain(*args, ITERS_B), m.dtype,
                           SPARSE_F32_TOL, f64_scaled=True)
    n, mc = q.shape[0], l.shape[0]
    ms = cuda_ms(lambda: admm_single(*args, ITERS_B), 20)
    plain_ms = cuda_ms(lambda: admm_single_plain(*args, ITERS_B), 3)
    # M1, A and the vectors read once, (w, y) written once; per iteration
    # four mat-vecs (A^T, M1, M1^T, A) and the element-wise updates
    nbytes = 4 * (n * n + mc * n + 3 * n + 5 * mc)
    flops = 2 * mc * n + 2 * mc + ITERS_B * (
        4 * mc * n + 4 * n * n + 5 * n + 12 * mc)
    bound_ms, bound_by = bound(nbytes, flops)
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, flops=flops,
               shape=f"n={n}, m={mc}, iters={ITERS_B}, f32")
    print(f"[admm_single] f32 n={n} m={mc} {ITERS_B} iters: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    earlier("admm_single", 1, n, mc, ITERS_B, ms)
    return out


def hold_select(tag, args, k=0):
    """One launch of kernel 2 on args (x, q, v, A, B, d, w_q, w_v) against
    its plain version: identical indices away from near-ties (an f64 gap
    under NEAR_TIE of the distance, from the call's own inputs), as many
    rows as states from k on, and bitwise-equal rows where the indices
    agree."""
    x = args[0]
    B = x.shape[0]
    d64 = point_distances_batch(*(a.double() if torch.is_tensor(a) else a
                                  for a in (x,) + tuple(args[1:3])
                                  + tuple(args[6:8])))
    two = torch.topk(d64, 2, dim=1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) < NEAR_TIE * two[:, 0]
    got = tpwl_select(*args, index_only=k)
    ref = tpwl_select_plain(*args, k)
    torch.cuda.synchronize()
    same = got[0] == ref[0]
    check(bool((same | near_tie).all()),
          f"tpwl_select {tag}: {int((~same & ~near_tie).sum())} "
          "index differences away from near-ties")
    check(all(a.shape[0] == B - k for a in got[1:]),
          f"tpwl_select {tag}: {got[1].shape[0]} rows, expected {B - k}")
    err = max([0.0] + [float(e.abs().max()) for e in (
        a[same[k:]] - b[same[k:]] for a, b in zip(got[1:], ref[1:]))
        if e.numel()])
    check(err == 0.0, f"tpwl_select {tag}: gathered rows differ")
    out = {"index_differences": int((~same).sum()), "max_abs_err": err,
           "near_ties": int(near_tie.sum()),
           "distinct_points": int(torch.unique(got[0]).numel())}
    print(f"[tpwl_select] {tag}: {out['index_differences']} index "
          f"differences, all at near-ties (f64 gap < {NEAR_TIE} rel; "
          f"{out['near_ties']} near-ties), gathered rows bitwise equal, "
          f"{out['distinct_points']} distinct points")
    return out


def phase_select(model64, model, x64, card):
    """Kernel 2 against its plain version (hold_select), f64 and f32, at
    B=5120, a ragged B=5119 and B=3072 with index_only=1024; then the
    plan, tick and index-only launches timed in f32."""
    out = {}
    B_plan, B_tick = N * B_MAIN, (1 + N_REPLAN) * B_MAIN
    for mdl in (model64, model):
        dic = (mdl.q, mdl.v, mdl.A_d, mdl.B_d, mdl.d_d, mdl.dist_w_q,
               mdl.dist_w_v)
        for B, k in ((B_plan, 0), (B_plan - 1, 0), (B_tick, B_MAIN)):
            x = x64[:B].to(mdl.q.dtype)
            tag = f"{str(x.dtype)[6:]} B={B} index_only={k}"
            out[tag] = hold_select(tag, (x,) + dic, k)
    dic = (model.q, model.v, model.A_d, model.B_d, model.d_d,
           model.dist_w_q, model.dist_w_v)
    for name, B, k in (("plan", B_plan, 0), ("tick", B_tick, B_MAIN),
                       ("index_only", B_plan, B_plan)):
        out[name] = select_row(f"tpwl_select {name} launch",
                               (x64[:B].float(),) + dic, k, card)
    return out


def check_logs(tag, logs, shape_z, shape_u, counts, want):
    """Launch counts as expected, logs finite, of the expected shapes, and
    commands inside the cables' range. Returns (z, u) as numpy."""
    print(f"[{tag}] launches: {counts}")
    for name, n in want.items():
        check(counts[name] == n,
              f"{tag}: {name} launched {counts[name]} times, expected {n}")
    z, u = logs["z"].cpu().numpy(), logs["u"].cpu().numpy()
    check(z.shape == shape_z and u.shape == shape_u,
          f"{tag}: log shapes {z.shape}, {u.shape}")
    check(np.isfinite(z).all() and np.isfinite(u).all(),
          f"{tag}: non-finite logs")
    check(u.min() >= 0.0 and u.max() <= 1500.0,
          f"{tag}: command outside [0, 1500]")
    return z, u


def cpu_agreement(tag, name, got, ref, tol):
    """Difference of a card run's logged z from the f64 CPU run's, relative
    to the CPU run's variation about its mean over time (and batch)."""
    axes = tuple(range(ref.ndim - 1))
    agree = float(np.linalg.norm(got - ref)
                  / np.linalg.norm(ref - ref.mean(axis=axes)))
    print(f"[{tag}] {name} card vs f64 CPU rel z difference {agree:.3e} "
          f"(tol {tol})")
    check(agree <= tol, f"{tag}: {name} card vs CPU difference {agree}")
    return agree


def device_events(fn):
    """{name: [device ms, count]} of the device operations of one call of
    fn(), from a profiler pass that records the device alone, and the
    seconds its summary took. The summary reads the profiler's raw
    events: its key_averages() builds an event tree on the host at some
    0.2 ms a device operation, minutes for a few passes of 300,000."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
            op = ops.setdefault(e.name(), [0.0, 0])
            op[0] += e.duration_ns() / 1e6
            op[1] += 1
    return ops, time.perf_counter() - t0


def profile_device(tag, fn, wall_ms):
    """Where the device time of one call of fn() goes, by kernel: printed,
    and returned with the device's busy share of `wall_ms` and the seconds
    the profiler's summary took."""
    ops, summary_s = device_events(fn)
    dev_ms = sum(ms for ms, _ in ops.values())
    top = sorted(ops.items(), key=lambda kv: kv[1][0], reverse=True)[:12]
    out = dict(device_ms=dev_ms, device_busy_share=dev_ms / wall_ms,
               device_kernel_launches=sum(n for _, n in ops.values()),
               profiler_summary_s=summary_s,
               top_device_ops=[{"name": name[:90], "ms": ms, "calls": n}
                               for name, (ms, n) in top])
    print(f"[{tag}] device busy {dev_ms:.2f} ms of {wall_ms:.2f} ms per "
          f"run (share {out['device_busy_share']:.3f}) in "
          f"{out['device_kernel_launches']} device operations (profiler "
          f"summary {summary_s:.1f} s); top device time:")
    for e in out["top_device_ops"]:
        print(f"[{tag}]   {e['ms']:8.3f} ms  {e['calls']:5d}x  {e['name']}")
    return out


def phase_fused(tag, mpc, model64, zt, card, want, want_f64, cpu_tol,
                n_timed):
    """A batch-fused loop (build_fused) at B_MAIN for N_WIN windows; `want`
    and `want_f64` are the launches a window of the f32 run and of the f64
    run on the card."""
    path = "condensed" if mpc.formulation == "condensed" else "A"
    run = mpc.build_fused(N_WIN)
    x0 = torch.zeros((B_MAIN, mpc.n_x), dtype=torch.float32,
                     device=mpc.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    logs = run(x0, x0, zt)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    T = N_WIN * N_REPLAN
    z, _ = check_logs(tag, logs, (B_MAIN, T, mpc.n_z), (B_MAIN, T, mpc.n_u),
                      counts, {k: v * N_WIN for k, v in want.items()})
    track = rel_track(z, zt)
    print(f"[{tag}] rel tracking error {track:.5f} (gate {QUALITY_GATE}); "
          f"peak device memory {peak_gb:.2f} GB")
    check(track <= QUALITY_GATE, f"{tag}: rel tracking error {track}")

    # host clock around whole runs: the spread is kept beside the median
    runs_ms = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x0, x0, zt)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    t_run = float(np.median(runs_ms)) / 1e3
    windows_per_s = B_MAIN * N_WIN / t_run
    print(f"[{tag}] {windows_per_s:.1f} windows/s (median of {n_timed} "
          f"runs: {1e3 * t_run:.2f} ms per {N_WIN}-window run at "
          f"B={B_MAIN}, f32; min {min(runs_ms):.2f}, max "
          f"{max(runs_ms):.2f} ms) [{card}]")
    out = dict(launches=counts, rel_track=track, peak_memory_gb=peak_gb,
               windows_per_s=windows_per_s, run_ms=1e3 * t_run,
               runs_ms=runs_ms)

    # where the time of one run goes: device time by kernel
    out.update(profile_device(tag, lambda: run(x0, x0, zt), 1e3 * t_run))

    # the same loop at B=8, in f32 and in f64 on the card, against the
    # port's f64 run on the CPU
    cpu_mpc = make_mpc(model64.to(device="cpu"), torch.float64, "cpu", path)
    out["cpu_mpc"] = cpu_mpc  # phase 25's f64 reference; not recorded
    x0c = np.zeros((B_CPU, mpc.n_x))
    ref = cpu_mpc.build_fused(N_WIN)(x0c, x0c, zt[:B_CPU])["z"].numpy()
    run64 = make_mpc(model64, torch.float64, mpc.device,
                     path).build_fused(N_WIN)
    for name, fn, tol in (("f32", run, cpu_tol),
                          ("f64", run64, F64_CPU_AGREE_TOL)):
        reset_counts()
        got = fn(x0c, x0c, zt[:B_CPU])["z"].cpu().numpy()
        counts = read_counts()
        out[f"cpu_rel_diff_{name}"] = cpu_agreement(
            tag, f"B={B_CPU} {name}", got, ref, tol)
        if name == "f64":
            print(f"[{tag}] f64 B={B_CPU} launches: {counts}")
            for k, v in want_f64.items():
                check(counts[k] == v * N_WIN, f"{tag} f64: {k} launched "
                      f"{counts[k]} times, expected {v * N_WIN}")
            out["launches_f64"] = counts
    return out


def phase_single_loop(mpc, model64, zt1, card):
    """Path B: the single-trajectory loop (build) for N_WIN_B windows."""
    run = mpc.build(N_WIN_B)
    x0 = torch.zeros(mpc.n_x, dtype=torch.float32, device=mpc.device)
    reset_counts()
    logs = run(x0, x0, zt1)
    torch.cuda.synchronize()
    counts = read_counts()
    T = N_WIN_B * N_REPLAN
    z, _ = check_logs("path B", logs, (T, mpc.n_z), (T, mpc.n_u), counts,
                      {"admm_single": N_WIN_B, "admm_stream": 0,
                       "admm_cluster": 0, "admm_batched": 0,
                       "tpwl_select": (1 + N_REPLAN) * N_WIN_B})
    track = rel_track(z[None], zt1[None])
    runs_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x0, x0, zt1)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    ms_win = float(np.median(runs_ms)) / N_WIN_B
    print(f"[path B] {ms_win:.3f} ms per window (host clock, median of 5 "
          f"runs of {N_WIN_B} windows, f32; runs {min(runs_ms):.2f} to "
          f"{max(runs_ms):.2f} ms); rel tracking error {track:.5f} (not "
          f"gated: R = 1e-3 I trades tracking for effort) [{card}]")
    cpu_mpc = make_mpc(model64.to(device="cpu"), torch.float64, "cpu", "B")
    x0c = np.zeros(mpc.n_x)
    ref = cpu_mpc.build(N_WIN_B)(x0c, x0c, zt1)["z"].numpy()
    z64 = make_mpc(model64, torch.float64, mpc.device, "B").build(N_WIN_B)(
        x0c, x0c, zt1)["z"].cpu().numpy()
    out = dict(launches=counts, ms_per_window=ms_win, runs_ms=runs_ms,
               rel_track=track)
    # where the time of one run goes (printed only; the loop is host-bound)
    out.update(profile_device("path B", lambda: run(x0, x0, zt1),
                              float(np.median(runs_ms))))
    for name, got, tol in (("f32", z, PATH_B_CPU_AGREE_TOL),
                           ("f64", z64, F64_CPU_AGREE_TOL)):
        out[f"cpu_rel_diff_{name}"] = cpu_agreement("path B", name, got,
                                                    ref, tol)
    return out

@contextlib.contextmanager
def recording(module, name, n=None, clone=8):
    """Within the block, record the positional arguments of the first n
    calls (every call if n is None) that the code makes to module.name (a
    kernel wrapper, or the select kernel's launch, as that module looks it
    up): the first `clone` copied, the rest as given. Yields the list of
    calls."""
    real = getattr(module, name)
    seen = []

    def record(*a, **k):
        if n is None or len(seen) < n:
            seen.append([t.clone() if i < clone and torch.is_tensor(t) else t
                         for i, t in enumerate(a)])
        return real(*a, **k)

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def results_of(module, name):
    """Within the block, what each call that the code makes to module.name
    returns (a list)."""
    real = getattr(module, name)
    seen = []

    def keep(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    setattr(module, name, keep)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def hold_path_selects(tag, model, calls):
    """hold_select on the first launch of each shape and table that a
    path made of kernel 2 (recorded at ops.tpwl_select._launch, with the
    states copied and the dictionary tables as given)."""
    out, seen = {}, set()
    for a in calls:
        table = "A_c" if a[3] is model.A_c else "A_d"
        key = (a[0].shape[0], table)
        if key in seen:
            continue
        seen.add(key)
        t = f"{tag} {str(a[0].dtype)[6:]} {key[0]} states on {table}"
        out[t] = hold_select(t, a[:8], a[8])
    check(bool(out), f"{tag}: no launch of tpwl_select to hold")
    return out


def kernel_row(tag, wrapper, args, iters, card, reps):
    """Time a batched ADMM kernel on the arguments of a path's launch (f32,
    or f64 where the path runs in f64), beside its plain version and its
    bound."""
    B, n, mc = args[2].shape[0], args[2].shape[1], args[3].shape[1]
    elem = args[0].element_size()
    ms = cuda_ms(lambda: wrapper(*args, iters), reps)
    clk = clocks()
    plain_ms = cuda_ms(lambda: admm_batched_plain(*args, iters), 3)
    nbytes, flops = admm_work(B, n, mc, iters)
    nbytes = nbytes * elem // 4
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[{tag}] {wrapper.__name__} f{8 * elem} B={B} n={n} m={mc} "
          f"{iters} iters: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}) [{card}; after it SM "
          f"clock, max, power, temperature: {clk}]")
    earlier(wrapper.__name__, B, n, mc, iters, ms, elem)
    return dict(kernel=wrapper.__name__, B=B, n=n, m=mc, iters=iters, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops, clocks=clk,
                dtype=str(args[0].dtype)[6:])


def rel_diff(got, ref):
    """max |got - ref| over max(max |ref|, 1)."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0))


def same_as_cpu(tag, name, got, ref, tol, iters_equal=True):
    """A card run's (x, u, iters, converged) against the f64 CPU run's:
    iteration counts and flags identical where `iters_equal`, x and u
    within tol relative."""
    d = max(rel_diff(got[0], ref[0]), rel_diff(got[1], ref[1]))
    same = (np.array_equal(got[2], ref[2]) and np.array_equal(got[3], ref[3]))
    print(f"[{tag}] {name} card vs f64 CPU: iterations and flags "
          f"{'identical' if same else 'differ'}, x and u rel difference "
          f"{d:.3e} (tol {tol})")
    check(all(np.isfinite(np.asarray(a, float)).all() for a in got[:2]),
          f"{tag} {name}: non-finite plan")
    if iters_equal:
        check(same, f"{tag} {name}: iterations {got[2]} / {ref[2]}, flags "
              f"{got[3]} / {ref[3]}")
    check(d <= tol, f"{tag} {name}: card vs CPU difference {d}")
    return dict(rel_diff=d, same_iterations=bool(same))


def make_gusto(model, dtype, formulation):
    """bench.py section 4's GuSTOJit on the TPWL model: N=5, Qz=100 I,
    R=1e-3 I, cables in [0, 1500] mN, GUSTO_ITERS SCP iterations of
    GUSTO_QP_ITERS ADMM iterations, K^-1 x-step."""
    nz, m_in = model.H.shape[0], model.input_dim
    return GuSTOJit(TPWLGuSTO(model), N=N, dt=0.01, Qz=100.0 * np.eye(nz),
                    R=1e-3 * np.eye(m_in),
                    U=HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in)),
                    max_iters=GUSTO_ITERS, qp_iters=GUSTO_QP_ITERS,
                    x_step="kinv", formulation=formulation, dtype=dtype)


def gusto_inputs(model, B):
    """bench.py:280-291's batch: x0 = 0.05 N(0, 1) (seed 2), zero inputs,
    the constant plan at x0, the output reference as the target."""
    rng = np.random.default_rng(2)
    x0 = 0.05 * rng.normal(size=(B, model.state_dim))
    u0 = np.zeros((B, N, model.input_dim))
    xi = np.repeat(x0[:, None], N + 1, axis=1)
    z = np.repeat(model.z_ref.cpu().numpy()[None, None], N + 1,
                  axis=1).repeat(B, axis=0)
    return x0, u0, xi, z


def gusto_result(r):
    return [a.cpu().numpy() for a in (r.x, r.u, r.iters, r.converged)]


def phase_gusto_fused(tag, formulation, model64, model, card, tol_f32):
    """GuSTOJit.solve_batch_fused at B=GUSTO_B on the campaign dictionary:
    the path's batched ADMM kernel against its plain version on the first
    iteration's LOCPs (f64 and f32) and timed in both, and kernel 2 against its
    plain version on the first iteration's select calls (the discrete rows
    at the B*N linearization states, the continuous rows at the 2*B*N
    states of the accuracy ratio); the path's launches (one ADMM launch an
    SCP iteration, two select launches), solves/s, the converged share and
    the device time by kernel; f64 and f32 card runs against the f64 CPU
    run at the same B."""
    kernel = admm_batched if formulation == "condensed" else admm_stream
    gj = make_gusto(model, torch.float32, formulation)
    gj64 = make_gusto(model64, torch.float64, formulation)
    args = gusto_inputs(model, GUSTO_B)
    out = {}
    for g, mdl in ((gj64, model64), (gj, model)):
        with recording(gusto_jit, "admm_batched", n=1) as qp, \
                recording(select_ops, "_launch", n=2, clone=1) as sel:
            g.solve_batch_fused(*args)
        ka, iters = qp[0][:8], qp[0][8]
        count = kernel.launches
        got = kernel(*ka, iters)
        check(kernel.launches == count + 1,
              f"{kernel.__name__} did not launch its kernel")
        key = f"{str(g.dtype)[6:]} B={GUSTO_B}"
        plain = admm_batched_plain(*ka, iters)
        out[key] = compare(kernel.__name__, f"{tag} {key}", got, plain,
                           g.dtype, ADMM_F32_TOL if formulation == "condensed"
                           else GUSTO_SPARSE_KERNEL_F32_TOL, f64_scaled=True)
        if g.dtype == torch.float64:  # the f64 path's launch, timed
            out[key]["ms"] = cuda_ms(lambda: kernel(*ka, iters), 10)
            print(f"[{tag}] {kernel.__name__} f64 B={GUSTO_B} "
                  f"n={ka[2].shape[1]} m={ka[3].shape[1]} {iters} iters: "
                  f"kernel {out[key]['ms']:.4f} ms [{card}]")
            earlier(kernel.__name__, GUSTO_B, ka[2].shape[1],
                    ka[3].shape[1], iters, out[key]["ms"], elem=8)
        if g.dtype == torch.float32:
            # both f32 results against the plain version in f64 on the
            # same (f32) inputs: the kernel's rounding beside the plain's
            exact = admm_batched_plain(*[t.double() for t in ka], iters)
            e_k, e_p = (max(float((a.double() - b).abs().max())
                            for a, b in zip(r, exact)) for r in (got, plain))
            limit = GUSTO_F32_ROUNDING_RATIO[formulation]
            out[key].update(err_vs_f64_kernel=e_k, err_vs_f64_plain=e_p)
            print(f"[{kernel.__name__}] {tag} {key} against f64 on the same "
                  f"inputs: kernel {e_k:.3e}, plain {e_p:.3e} (ratio "
                  f"{e_k / e_p:.2f}, limit {limit})")
            check(e_k <= limit * e_p, f"{tag} {key}: the kernel's f32 error "
                  f"{e_k} exceeds {limit} x the plain version's {e_p}")
        out[f"select {key}"] = hold_path_selects(tag, mdl, sel)
    out["kernel_row"] = kernel_row(tag, kernel, ka, iters, card, 20)

    reset_counts()
    r = gj.solve_batch_fused(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 0 for k in KERNELS}
    want.update({kernel.__name__: GUSTO_ITERS, "tpwl_select": 2 * GUSTO_ITERS})
    print(f"[{tag}] launches a solve of B={GUSTO_B}: {counts}")
    check(counts == want, f"{tag}: launches {counts}, expected {want}")
    x, u = r.x.cpu().numpy(), r.u.cpu().numpy()
    check(x.shape == (GUSTO_B, N + 1, model.state_dim)
          and u.shape == (GUSTO_B, N, model.input_dim), f"{tag}: shapes")
    check(np.isfinite(x).all() and np.isfinite(u).all(), f"{tag}: non-finite")
    conv = float(r.converged.float().mean())
    runs_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gj.solve_batch_fused(*args)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    t_solve = float(np.median(runs_ms))
    print(f"[{tag}] {1e3 * GUSTO_B / t_solve:.1f} solves/s (B={GUSTO_B}, "
          f"median of 5: {t_solve:.2f} ms a batch, f32; min "
          f"{min(runs_ms):.2f}, max {max(runs_ms):.2f}); converged share "
          f"{conv:.3f}; SCP iterations {np.bincount(r.iters.cpu().numpy())}"
          f" [{card}]")
    out.update(launches=counts, solves_per_s=1e3 * GUSTO_B / t_solve,
               batch_ms=t_solve, runs_ms=runs_ms, converged_share=conv)
    out.update(profile_device(tag, lambda: gj.solve_batch_fused(*args),
                              t_solve))

    t0 = time.perf_counter()
    ref = gusto_result(make_gusto(model64.to(device="cpu"), torch.float64,
                                  formulation).solve_batch_fused(*args))
    out["cpu_f64_s"] = time.perf_counter() - t0
    print(f"[{tag}] f64 CPU reference at B={GUSTO_B}: "
          f"{out['cpu_f64_s']:.2f} s")
    reset_counts()
    got64 = gusto_result(gj64.solve_batch_fused(*args))
    counts64 = read_counts()
    check(counts64[kernel.__name__] == GUSTO_ITERS,
          f"{tag} f64: launches {counts64}")
    out["launches_f64"] = counts64
    out["cpu_f64"] = same_as_cpu(tag, f"f64 B={GUSTO_B}", got64, ref,
                                 F64_CPU_AGREE_TOL)
    out["cpu_f32"] = same_as_cpu(tag, f"f32 B={GUSTO_B}", gusto_result(
        gj.solve_batch_fused(*args)), ref, tol_f32, iters_equal=False)
    return out


def phase_gusto_realtime(model64, model, card):
    """GuSTO(device_tr=True) behind GuSTOService: RT_QUERIES MPC queries,
    each one trust-region loop on the device (linearization through the
    select kernel; the QP in plain PyTorch, as the JAX package runs it in
    XLA), each next query from the plan's state N_REPLAN steps on. Kernel
    2 is held to its plain version on the first call of each shape and
    table that the queries made, in f32 and f64."""
    T = 200
    t = 0.01 * np.arange(T)
    z_rel = feasible_outputs(model64, 1, T)[0] - model64.z_ref.cpu().numpy()

    def service(mdl, dtype):
        nz, m_in = mdl.H.shape[0], mdl.input_dim
        return GuSTOService(
            TPWLGuSTO(mdl), N, 0.01, 100.0 * np.eye(nz), 1e-3 * np.eye(m_in),
            np.zeros(mdl.state_dim), t=t, z=z_rel,
            U=HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in)),
            locp_backend="condensed", device_tr=True,
            device_tr_qp_iters=RT_QP_ITERS, dtype=dtype)

    def queries(svc, times=None):
        xs, us, iters = [], [], []
        x = np.zeros(svc.gusto.n_x)
        for k in range(RT_QUERIES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.send_request(0.01 * N_REPLAN * k, x, wait=True)
            _, u, xp, _ = svc.get_solution()
            if times is not None:
                times.append(1e3 * (time.perf_counter() - t0))
            xs.append(xp)
            us.append(u)
            iters.append(svc.gusto.itr_count)
            x = xp[N_REPLAN]
        return [np.stack(xs), np.stack(us), np.array(iters),
                np.array([svc.gusto.plan_rejects])]

    t0 = time.perf_counter()
    svc = service(model, torch.float32)
    setup_s = time.perf_counter() - t0
    reset_counts()
    times = []
    with recording(select_ops, "_launch", clone=1) as sel32:
        got32 = queries(svc, times)
    counts = read_counts()
    print(f"[gusto real-time] launches over {RT_QUERIES} queries: {counts}")
    check(counts["tpwl_select"] > 0 and all(
        counts[k] == 0 for k in KERNELS if k != "tpwl_select"),
        f"gusto real-time: launches {counts}")
    print(f"[gusto real-time] {np.median(times):.2f} ms a query (host clock, "
          f"median of {RT_QUERIES}: {', '.join(f'{x:.1f}' for x in times)} "
          f"ms; SCP iterations {got32[2].tolist()}, plan rejects "
          f"{int(got32[3][0])}; set-up {setup_s:.2f} s), f32 [{card}]")
    out = dict(launches=counts, query_ms=float(np.median(times)),
               queries_ms=times, scp_iterations=got32[2].tolist(),
               setup_s=setup_s)
    with recording(select_ops, "_launch", clone=1) as sel64:
        got64 = queries(service(model64, torch.float64))
    for mdl, calls in ((model64, sel64), (model, sel32)):
        out[f"select {str(mdl.q.dtype)[6:]}"] = hold_path_selects(
            "gusto real-time", mdl, calls)
    ref = queries(service(model64.to(device="cpu"), torch.float64))
    out["cpu_f64"] = same_as_cpu("gusto real-time", "f64", got64, ref,
                                 F64_CPU_AGREE_TOL)
    out["cpu_f32"] = same_as_cpu("gusto real-time", "f32", got32, ref,
                                 GUSTO_RT_F32_TOL, iters_equal=False)
    return out


def phase_lti(Cf, Hf, card, dev):
    """The LTI MPC service step on the campaign's linear ROM at bench.py's
    settings (N=20, Qz=100 I, R=1e-4 I, Qf=1000 I, cables in [0, 1500]),
    condensed, with each QP backend: 'pallas' (four stages of the batched
    ADMM kernel at B=1) and 'xla' (the adaptive solver). f32 steps timed
    as bench.py times them; f64 card steps against the f64 CPU's."""
    data = tpwl_to_linear_rom(ARTIFACT)
    dt = 0.01

    def service(bk, dtype, device):
        lin = LinearROM(data, dt, Cf=Cf, Hf=Hf, device=device)
        nz, m_in = lin.H.shape[0], lin.input_dim
        tt = dt * np.arange(1200)
        zt = np.zeros((len(tt), nz))
        zt[:, 0] = 15.0 * np.sin(2 * np.pi * tt / 2.0)
        zt[:, 1] = 7.5 * np.sin(4 * np.pi * tt / 2.0)
        return LinearMPCService(
            lin, LTI_N, dt, QuadraticCost(Q=100.0 * np.eye(nz),
                                          R=1e-4 * np.eye(m_in),
                                          Qf=1000.0 * np.eye(nz)),
            Target(t=tt, z=zt - lin.z_ref.cpu().numpy()),
            U=HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in)),
            locp_backend="condensed", qp_backend=bk, dtype=dtype)

    def steps(svc):
        xs, us = [], []
        x = np.zeros(svc.locp.spec.n_x)
        for k in range(LTI_STEPS):
            svc.send_request(0.37 + dt * k, x, wait=True)
            _, u, xp, _ = svc.get_solution()
            xs.append(xp)
            us.append(u)
            x = xp[1]
        return [np.stack(xs), np.stack(us), np.zeros(1), np.zeros(1)]

    out = {}
    for bk in ("pallas", "xla"):
        svc = service(bk, torch.float32, dev)
        sdt, dev = svc.locp.spec.dtype, svc.device
        t0_d = torch.as_tensor(0.37, dtype=sdt, device=dev)
        x0_d = torch.zeros(svc.locp.spec.n_x, dtype=sdt, device=dev)
        step = lambda: svc._fused_fn(t0_d, x0_d, svc._w, svc._y)
        reset_counts()
        step()
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: 0 for k in KERNELS}
        if bk == "pallas":
            want["admm_batched"] = 4
        print(f"[lti {bk}] launches a step: {counts}")
        check(counts == want, f"lti {bk}: launches {counts}, expected {want}")
        runs_ms = []
        for _ in range(22):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            runs_ms.append(1e3 * (time.perf_counter() - t0))
        runs_ms = runs_ms[2:]
        ms = float(np.median(runs_ms))
        print(f"[lti {bk}] {ms:.3f} ms a service step (host clock, median "
              f"of 20; min {min(runs_ms):.3f}, max {max(runs_ms):.3f}), f32 "
              f"[{card}]")
        o = dict(launches=counts, step_ms=ms, runs_ms=runs_ms)
        if bk == "pallas":
            o.update(profile_device(f"lti {bk}", step, ms))
            with recording(batch_mpc, "admm_batched", n=1) as qp:
                step()
            ka, iters = qp[0][:8], qp[0][8]
            count = admm_batched.launches
            got = admm_batched(*ka, iters)
            check(admm_batched.launches == count + 1,
                  "admm_batched did not launch its kernel")
            o["f32 B=1"] = compare("admm_batched", f"lti {bk} f32 B=1", got,
                                   admm_batched_plain(*ka, iters),
                                   torch.float32, ADMM_F32_TOL)
            o["kernel_row"] = kernel_row(f"lti {bk}", admm_batched, ka,
                                         iters, card, 50)
        ref = steps(service(bk, torch.float64, "cpu"))
        o["cpu_f64"] = same_as_cpu(f"lti {bk}", "f64", steps(
            service(bk, torch.float64, dev)), ref, F64_CPU_AGREE_TOL)
        o["cpu_f32"] = same_as_cpu(f"lti {bk}", "f32", steps(svc), ref,
                                   LTI_F32_TOL, iters_equal=False)
        out[bk] = o
    return out


def make_ssm_mpc(model, dtype, device, formulation):
    """bench.py section 5's BatchSSMMPC: Qz = 100 on the tip's x and y,
    R = 1e-6 I, N=3, dt=0.02, N_replan=2, 50 ADMM iterations."""
    Qz = np.zeros((model.output_dim, model.output_dim))
    Qz[0, 0] = Qz[1, 1] = 100.0
    return BatchSSMMPC(model, Qz, 1e-6 * np.eye(model.input_dim), N=SSM_N,
                       dt=SSM_DT, N_replan=SSM_N_REPLAN,
                       qp_iters=SSM_QP_ITERS, formulation=formulation,
                       dtype=dtype, device=device)


def ssm_targets(B, n_win):
    """bench.py:376-384: a 2 mm circle through the start in the tip's
    (x, y), one phase a loop from default_rng(7), shifted coordinates,
    windowed (B, n_win, N+1, n_z)."""
    T = n_win * SSM_N_REPLAN + SSM_N + 1
    ts = SSM_DT * np.arange(T)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(B):
        ph = rng.uniform(0, 2 * np.pi)
        zz = np.zeros((T, 6))
        zz[:, 0] = 2.0 * np.cos(2 * np.pi * ts / 6.0 + ph) - 2.0 * np.cos(ph)
        zz[:, 1] = 2.0 * np.sin(2 * np.pi * ts / 6.0 + ph) - 2.0 * np.sin(ph)
        out.append(window_targets(zz, n_win, SSM_N_REPLAN, SSM_N))
    return np.stack(out)


def ssm_logs(logs, z_ref):
    """(outputs about z_ref, commands) of a run, as f64 numpy."""
    return (logs["z"].double().cpu().numpy() - z_ref,
            logs["u"].double().cpu().numpy())


def log_diff(got, ref):
    """max |got - ref| over max |ref|, the larger of outputs and commands."""
    return max(float(np.abs(g - r).max() / np.abs(r).max())
               for g, r in zip(got, ref))


def phase_ssm(tag, name, formulation, B, card, dev, timed):
    """BatchSSMMPC.build_fused on an SSM artifact at B loops for SSM_N_WIN
    windows from rest on `dev` (see the module docstring, phase 14);
    `timed` adds windows/s, kernel 1 timed alone and a profiler pass."""
    model64 = from_mat(SSM_ARTIFACTS[name], None, discrete=False,
                       discr_method="be", device=dev)
    z_ref = model64.z_ref.cpu().numpy()
    zt, x0 = ssm_targets(B, SSM_N_WIN), np.zeros((B, model64.state_dim))
    mpc = make_ssm_mpc(model64, torch.float32, dev, formulation)
    run = mpc.build_fused(SSM_N_WIN)
    run64 = make_ssm_mpc(model64, torch.float64, dev,
                         formulation).build_fused(SSM_N_WIN)
    out = {"qp": dict(zip(("n", "m"), mpc._qp_dims()))}
    print(f"[{tag}] {name} SSM: n_x={mpc.n_x}, n_u={mpc.n_u}, "
          f"n_z={mpc.n_z}; QP of n={out['qp']['n']}, m={out['qp']['m']}, "
          f"B={B}")

    # kernel 1 against its plain version on the first window's launch
    for fn, dt in ((run64, torch.float64), (run, torch.float32)):
        with recording(batch_mpc, "admm_batched", n=1) as qp:
            fn(x0, zt)
        ka, iters = qp[0][:8], qp[0][8]
        count = admm_batched.launches
        got = admm_batched(*ka, iters)
        check(admm_batched.launches == count + 1,
              "admm_batched did not launch its kernel")
        key = f"{str(dt)[6:]} B={B}"
        plain = admm_batched_plain(*ka, iters)
        ratio = {}
        tol_f32 = (ADMM_F32_TOL if formulation == "condensed"
                   else SPARSE_F32_TOL)
        if dt == torch.float32:
            exact = admm_batched_plain(*[t.double() for t in ka], iters)
            e_k, e_p = (max(float((a.double() - b).abs().max())
                            for a, b in zip(r, exact)) for r in (got, plain))
            ratio = dict(err_vs_f64_kernel=e_k, err_vs_f64_plain=e_p)
            print(f"[admm_batched] {tag} {key} against f64 on the same "
                  f"inputs: kernel {e_k:.3e}, plain {e_p:.3e} (ratio "
                  f"{e_k / e_p:.2f}, limit {SSM_F32_ROUNDING_RATIO})")
            check(e_k <= SSM_F32_ROUNDING_RATIO * e_p, f"{tag} {key}: the "
                  f"kernel's f32 error {e_k} exceeds "
                  f"{SSM_F32_ROUNDING_RATIO} x the plain version's {e_p}")
            scale = max(max(float(b.abs().max()) for b in plain), 1.0)
            tol_f32 = max(tol_f32, 2.0 * e_p / scale)
        out[key] = compare("admm_batched", f"{tag} {key}", got, plain, dt,
                           tol_f32, f64_scaled=True)
        out[key].update(ratio)

    # the path: exactly one launch of kernel 1 a window
    want = {k: 0 for k in KERNELS}
    want["admm_batched"] = SSM_N_WIN
    for fn, dt in ((run, "f32"), (run64, "f64")):
        torch.cuda.synchronize()
        reset_counts()
        logs = fn(x0, zt)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"[{tag}] {dt} launches a run of {SSM_N_WIN} windows: {counts}")
        check(counts == want, f"{tag} {dt}: launches {counts}, expected "
              f"{want}")
        out["launches" if dt == "f32" else "launches_f64"] = counts
        T = SSM_N_WIN * SSM_N_REPLAN
        check(tuple(logs["z"].shape) == (B, T, mpc.n_z)
              and tuple(logs["u"].shape) == (B, T, mpc.n_u),
              f"{tag} {dt}: log shapes")
        out[f"logs_{dt}"] = ssm_logs(logs, z_ref)
        check(all(np.isfinite(a).all() for a in out[f"logs_{dt}"]),
              f"{tag} {dt}: non-finite logs")

    # agreement with the port's f64 run on the CPU
    t0 = time.perf_counter()
    ref = ssm_logs(make_ssm_mpc(model64.to(device="cpu"), torch.float64,
                                "cpu", formulation).build_fused(SSM_N_WIN)(
                                    x0, zt), z_ref)
    out["cpu_f64_s"] = time.perf_counter() - t0
    print(f"[{tag}] f64 CPU reference at B={B}: {out['cpu_f64_s']:.2f} s; "
          f"outputs move up to {np.abs(ref[0]).max():.4e} about z_ref, "
          f"commands up to {np.abs(ref[1]).max():.4e}")
    for dt, tol in (("f64", F64_CPU_AGREE_TOL),
                    ("f32", SSM_F32_TOL[formulation])):
        d = log_diff(out.pop(f"logs_{dt}"), ref)
        out[f"cpu_rel_diff_{dt}"] = d
        print(f"[{tag}] {dt} card vs f64 CPU: max log difference {d:.3e} "
              f"of the logs' scale (tol {tol})")
        check(d <= tol, f"{tag} {dt}: card vs CPU difference {d}")
    if not timed:
        return out

    # windows/s as bench.py's timeit: warm-up 2, then 5 calls back to back
    for _ in range(2):
        run(x0, zt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        run(x0, zt)
    torch.cuda.synchronize()
    t_run = (time.perf_counter() - t0) / 5
    runs_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        run(x0, zt)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    out.update(windows_per_s=B * SSM_N_WIN / t_run, run_ms=1e3 * t_run,
               runs_ms=runs_ms)
    print(f"[{tag}] {out['windows_per_s']:.1f} windows/s ({1e3 * t_run:.2f} "
          f"ms per {SSM_N_WIN}-window run at B={B}, f32, mean of 5 back to "
          f"back; runs synchronized one by one: "
          f"{', '.join(f'{t:.2f}' for t in runs_ms)} ms) [{card}]")
    out["kernel_row"] = kernel_row(tag, admm_batched, ka, iters, card, 50)
    out["kernel_row"]["launches"] = SSM_N_WIN
    out.update(profile_device(tag, lambda: run(x0, zt), 1e3 * t_run))
    return out


# ---------------------------------------------------------------------------
# Phases 15-18: the long-horizon stage LOCP and GuSTO's stage backend, and
# the LTI baselines ROMPC and Koopman MPC


@contextlib.contextmanager
def counting(cls, name):
    """Within the block, each call of the method cls.name appends (its
    result, seconds to the device's end)."""
    real = getattr(cls, name)
    calls = []

    def timed(*a, **k):
        t0 = time.perf_counter()
        r = real(*a, **k)
        torch.cuda.synchronize()
        calls.append((r, time.perf_counter() - t0))
        return r

    setattr(cls, name, timed)
    try:
        yield calls
    finally:
        setattr(cls, name, real)


def ops_per_call(fn_of, n_lo, n_hi, n):
    """Device operations and device ms of fn_of(n) from profiler passes at
    n_lo and n_hi repetitions (a + b n is exact for a loop of fixed
    work)."""
    lo, hi = (profile_quiet(fn_of(k)) for k in (n_lo, n_hi))
    per = [(h - l) / (n_hi - n_lo) for l, h in zip(lo, hi)]
    return [l + (n - n_lo) * p for l, p in zip(lo, per)]


def profile_quiet(fn):
    """(device operations, device ms) of one call of fn()."""
    ops, _ = device_events(fn)
    return (sum(n for _, n in ops.values()),
            sum(ms for ms, _ in ops.values()))


def host_ms(fn, runs):
    """Host-clock ms of fn() synchronized, `runs` times after one
    warm-up."""
    fn()
    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def phase_stage_locp(model64, card, dev):
    """bench.py section 4b (bench.py:301-332): the campaign dictionary's
    first discrete point repeated over N=STAGE_N, H of the model, Qz=100 I,
    R=1e-3 I, cables in [0, 1500] mN, z = 0.05 N(0, 1) (seed 3), x0 = 0,
    STAGE_ITERS ADMM iterations, kkt_solver 'cr' and 'scan'. No kernel of
    the port runs here (the JAX package computes this in XLA): ms a solve,
    device operations a solve, the device's busy share; f32 and f64 card
    runs against the f64 CPU run, 'cr' against 'scan'."""
    nz, m_in, nx = model64.H.shape[0], model64.input_dim, model64.state_dim
    rng = np.random.default_rng(3)
    z = 0.05 * rng.normal(size=(STAGE_N + 1, nz))
    first = lambda a: a[:1].double().cpu().numpy().repeat(STAGE_N, axis=0)
    data = (first(model64.A_d), first(model64.B_d), first(model64.d_d),
            np.zeros(nx), z)
    H = model64.H.cpu().numpy()
    U = HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in))

    def solver(kkt, dtype, device, iters=STAGE_ITERS):
        st = StageLOCP(STAGE_N, H, 100.0 * np.eye(nz), 1e-3 * np.eye(m_in),
                       U=U, kkt_solver=kkt, dtype=dtype, device=device)
        args = [torch.as_tensor(a, dtype=dtype, device=st.device)
                for a in data]
        return st, lambda: st.solve(*args, iters=iters)[0]

    out, ws = {}, {}
    for kkt in ("cr", "scan"):
        st, fn = solver(kkt, torch.float32, dev)
        reset_counts()
        w = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        check(all(v == 0 for v in counts.values()),
              f"stage {kkt}: kernel launches {counts}")
        runs = host_ms(fn, STAGE_RUNS)
        ms = float(np.median(runs))
        n_ops, dev_ms = ops_per_call(
            lambda k: solver(kkt, torch.float32, dev, k)[1], 2, 12,
            STAGE_ITERS)
        clk = clocks()
        ref = solver(kkt, torch.float64, "cpu")[1]().numpy()
        w64 = solver(kkt, torch.float64, dev)[1]().cpu().numpy()
        check(np.isfinite(w.cpu().numpy()).all(), f"stage {kkt}: non-finite")
        d64 = rel_diff(w64, ref)
        d32 = rel_diff(w.cpu().numpy(), ref)
        print(f"[stage {kkt}] N={STAGE_N}, n_x={nx}, n_u={m_in}, n_z={nz}, "
              f"{STAGE_ITERS} ADMM iterations, f32: {ms:.2f} ms a solve "
              f"({1e3 / ms:.2f} solves/s; host clock, median of "
              f"{STAGE_RUNS}: {', '.join(f'{t:.2f}' for t in runs)}), "
              f"{n_ops:.0f} device operations a solve, device busy "
              f"{dev_ms:.2f} ms (share {dev_ms / ms:.3f}) [{card}; after it "
              f"SM clock, max, power, temperature: {clk}]")
        print(f"[stage {kkt}] card vs f64 CPU, w over its scale: f64 "
              f"{d64:.3e} (tol {F64_CPU_AGREE_TOL}), f32 {d32:.3e} (tol "
              f"{STAGE_F32_TOL[kkt]})")
        check(d64 <= F64_CPU_AGREE_TOL, f"stage {kkt} f64: {d64}")
        check(d32 <= STAGE_F32_TOL[kkt], f"stage {kkt} f32: {d32}")
        ws[kkt] = (w.cpu().numpy(), ref)
        out[kkt] = dict(ms=ms, runs_ms=runs, solves_per_s=1e3 / ms,
                        device_ops=n_ops, device_ms=dev_ms,
                        device_busy_share=dev_ms / ms, launches=counts,
                        cpu_rel_diff_f64=d64, cpu_rel_diff_f32=d32,
                        clocks=clk)
    d_cpu = rel_diff(ws["cr"][1], ws["scan"][1])
    d_card = rel_diff(ws["cr"][0], ws["scan"][0])
    print(f"[stage] 'cr' against 'scan', w over its scale: f64 CPU "
          f"{d_cpu:.3e} (tol {STAGE_CR_SCAN_F64_TOL}), f32 card {d_card:.3e}"
          f" (tol {STAGE_F32_TOL['cr']})")
    check(d_cpu <= STAGE_CR_SCAN_F64_TOL, f"stage cr vs scan f64: {d_cpu}")
    check(d_card <= STAGE_F32_TOL["cr"], f"stage cr vs scan f32: {d_card}")
    out.update(cr_vs_scan_f64_cpu=d_cpu, cr_vs_scan_f32_card=d_card)
    return out


def stage_gusto_run(tag, make, min_select=0):
    """run_gusto_standalone through make() with its LOCP solves counted
    and timed: (plan, solves [(accepted, s)], wall s, launches). On the
    card kernel 2 must have launched at least min_select times, and no
    other kernel."""
    reset_counts()
    t0 = time.perf_counter()
    with counting(StageLOCPAdapter, "solve") as calls:
        xopt, uopt, zopt, _, g = make()
    wall = time.perf_counter() - t0
    counts = read_counts()
    solves = [(bool(r[1]), s) for r, s in calls]
    plan = [np.asarray(xopt, float), np.asarray(uopt, float),
            np.array([len(solves)]), np.array([a for a, _ in solves])]
    print(f"[{tag}] {len(solves)} LOCP solves (accepted: "
          f"{[a for a, _ in solves]}), {wall:.2f} s in all, "
          f"{1e3 * np.median([s for _, s in solves]):.1f} ms an SCP "
          f"iteration (median LOCP solve); launches {counts}")
    check(all(np.isfinite(a).all() for a in plan[:2]), f"{tag}: non-finite")
    check(counts["tpwl_select"] >= min_select
          and all(counts[k] == 0 for k in KERNELS if k != "tpwl_select"),
          f"{tag}: launches {counts}")
    return plan, solves, wall, counts


def phase_stage_gusto(model64, model, card, dev):
    """GuSTO(locp_backend='stage') through run_gusto_standalone at N=200:
    the Dubins car (tests/test_locp_stages.py:228-252's settings: dt=0.05,
    Qz = diag(1, 1, 0), R = 0.05 I, speed in [0, 1], a line to (4, 2),
    2000 ADMM iterations an LOCP) and the campaign TPWL dictionary
    (TPWLGuSTO, dt=0.01, Qz = 100 I, R = 1e-3 I, cables in [0, 1500] mN,
    a feasible output target, STAGE_GUSTO_ADMM_ITERS iterations an LOCP).
    The Dubins loop in f32 and f64 on the card and f64 on the CPU; the
    campaign's in f32 and f64 on the card, its first LOCP also solved on
    the CPU in f64; kernel 2 counted and held to its plain version on the
    first call of each shape and table."""
    out = {}
    N, dt = STAGE_N, 0.05
    t = dt * np.arange(N + 1)
    z = np.stack([4.0 * t / t[-1], 2.0 * t / t[-1], 0.0 * t], axis=1)

    def dubins(dtype, device):
        return lambda: run_gusto_standalone(
            DubinsCar(dtype=dtype, device=device), N, dt,
            np.diag([1.0, 1.0, 0.0]), 0.05 * np.eye(2), np.zeros(3), z=z,
            U=HyperRectangle([1.0, 1.0], [0.0, -1.0]), locp_backend="stage",
            iters=2000, max_gusto_iters=10, dtype=dtype)

    runs = {}
    for name, dtype, device in (("f32", torch.float32, dev),
                                ("f64", torch.float64, dev),
                                ("cpu", torch.float64, "cpu")):
        runs[name] = stage_gusto_run(f"gusto stage dubins {name}",
                                     dubins(dtype, device))
    out["dubins"] = stage_gusto_compare("gusto stage dubins", runs, card)

    z_rel = (feasible_outputs(model64, 1, N + 1)[0]
             - model64.z_ref.cpu().numpy())
    nz, m_in = model64.H.shape[0], model64.input_dim
    Qz, R = 100.0 * np.eye(nz), 1e-3 * np.eye(m_in)
    U = HyperRectangle(1500.0 * np.ones(m_in), np.zeros(m_in))

    def diamond(mdl, dtype):
        return lambda: run_gusto_standalone(
            TPWLGuSTO(mdl), N, 0.01, Qz, R, np.zeros(mdl.state_dim),
            z=z_rel, U=U, locp_backend="stage",
            iters=STAGE_GUSTO_ADMM_ITERS, dtype=dtype)

    # kernel 2: the rollout's N steps and the first linearization, then
    # the accuracy ratio's two and a relinearization as the loop goes
    runs = {}
    for name, mdl, dtype in (("f32", model, torch.float32),
                             ("f64", model64, torch.float64)):
        with recording(select_ops, "_launch", clone=1) as sel, \
                first_locp() as first, scp_iterations(STAGE_GUSTO_SCP_ITERS):
            runs[name] = stage_gusto_run(f"gusto stage diamond {name}",
                                         diamond(mdl, dtype), N + 1)
        out[f"select {name}"] = hold_path_selects(
            f"gusto stage diamond {name}", mdl, sel)
        if name == "f32":
            lin = next(a for a in sel if a[0].shape[0] == N
                       and a[3] is mdl.A_d)
            out["select_row"] = select_row("gusto stage diamond", lin[:8],
                                           lin[8], card)
    # the f64 run's first LOCP solved again by the adapter on the CPU (the
    # whole loop there takes minutes: 5 solves of 6000 iterations)
    t0 = time.perf_counter()
    cpu = StageLOCPAdapter(N, model64.H.cpu().numpy(), Qz, R, U=U,
                           iters=STAGE_GUSTO_ADMM_ITERS, dtype=torch.float64,
                           device="cpu")
    cpu.update(*first["args"], **first["kwargs"])
    J, ok, _ = cpu.solve()
    ref = cpu.get_solution()[:2]
    d = max(rel_diff(a, b) for a, b in zip(first["solution"], ref))
    rel_J = abs(J - first["J"]) / max(abs(J), 1.0)
    print(f"[gusto stage diamond] first LOCP, f64 card vs f64 CPU "
          f"({time.perf_counter() - t0:.1f} s): accepted {first['ok']} / "
          f"{ok}, objective rel difference {rel_J:.3e}, x and u rel "
          f"difference {d:.3e} (tol {F64_CPU_AGREE_TOL})")
    check(ok == first["ok"] and d <= F64_CPU_AGREE_TOL
          and rel_J <= F64_CPU_AGREE_TOL,
          f"gusto stage diamond first LOCP: card vs CPU {d}, {rel_J}")
    out["diamond"] = {}
    for name in ("f32", "f64"):
        _, solves, wall, counts = runs[name]
        out["diamond"][name] = dict(
            solves=len(solves), accepted=[a for a, _ in solves],
            ms_per_scp_iteration=1e3 * float(np.median(
                [s for _, s in solves])),
            locp_ms=[1e3 * s for _, s in solves], wall_s=wall,
            launches=counts)
    out["diamond"]["first_locp_cpu_rel_diff"] = d
    out["launches"] = runs["f32"][3]
    out["launches_f64"] = runs["f64"][3]
    return out


@contextlib.contextmanager
def scp_iterations(n):
    """Within the block, GuSTO's first solve runs at most n SCP
    iterations (scp/gusto.py:MAX_ITERS, which its construction reads)."""
    real = gusto_mod.MAX_ITERS
    gusto_mod.MAX_ITERS = n - 1
    try:
        yield
    finally:
        gusto_mod.MAX_ITERS = real


@contextlib.contextmanager
def first_locp():
    """Within the block, the first update of a StageLOCPAdapter (its
    arguments on the CPU) and the first solve's (J, accepted, x, u)."""
    from soft_robot_control_tpu_torch.scp.locp_stages import (
        StageLOCPAdapter)

    rec = {}
    update, solve = StageLOCPAdapter.update, StageLOCPAdapter.solve
    cpu = lambda a: a.cpu() if torch.is_tensor(a) else a

    def rec_update(self, *a, **k):
        if "args" not in rec:
            rec["args"] = [cpu(v) for v in a]
            rec["kwargs"] = {key: cpu(v) for key, v in k.items()}
        return update(self, *a, **k)

    def rec_solve(self):
        r = solve(self)
        if "J" not in rec:
            rec.update(J=r[0], ok=r[1], solution=self.get_solution()[:2])
        return r

    StageLOCPAdapter.update, StageLOCPAdapter.solve = rec_update, rec_solve
    try:
        yield rec
    finally:
        StageLOCPAdapter.update, StageLOCPAdapter.solve = update, solve


def stage_gusto_compare(tag, runs, card):
    """The f64 card run against the f64 CPU run (identical solves and
    acceptance, plans within F64_CPU_AGREE_TOL), the f32 run's difference
    (held to STAGE_GUSTO_F32_TOL where its solves match); ms an SCP
    iteration of each card run."""
    ref = runs["cpu"][0]
    rec = {}
    for name in ("f64", "f32"):
        plan, solves, wall, counts = runs[name]
        rec[name] = dict(
            solves=len(solves), accepted=[a for a, _ in solves],
            ms_per_scp_iteration=1e3 * float(np.median([s for _, s in
                                                        solves])),
            locp_ms=[1e3 * s for _, s in solves], wall_s=wall,
            launches=counts)
        same = (np.array_equal(plan[2], ref[2])
                and np.array_equal(plan[3], ref[3]))
        d = max(rel_diff(plan[0], ref[0]), rel_diff(plan[1], ref[1]))
        rec[name].update(same_solves_as_cpu=bool(same), cpu_rel_diff=d)
        print(f"[{tag}] {name} card vs f64 CPU: solves and acceptance "
              f"{'identical' if same else 'differ'}, x and u rel difference "
              f"{d:.3e}; {rec[name]['ms_per_scp_iteration']:.1f} ms an SCP "
              f"iteration [{card}]")
        if name == "f64":
            check(same and d <= F64_CPU_AGREE_TOL,
                  f"{tag} f64: solves {plan[3]} / {ref[3]}, difference {d}")
        elif same:
            check(d <= STAGE_GUSTO_F32_TOL, f"{tag} f32: difference {d}")
    return rec


def select_row(tag, args, k, card):
    """Kernel 2 timed on the arguments (x, q, v, A, B, d, w_q, w_v) of a
    launch with index_only=k, beside its plain version and its bound:
    states and dictionary coordinates read once, the rows that the states
    k.. select read once, their rows and every index written once; per
    state and point 3 operations a coordinate, 2 roots, 3 more."""
    x, q = args[0], args[1]
    B, (P, r) = x.shape[0], q.shape
    n, mu = args[4].shape[1:]
    row = n * n + n * mu + n
    n_rows = int(torch.unique(tpwl_select(*args)[0][k:]).numel())
    ms = cuda_ms(lambda: tpwl_select(*args, index_only=k), 50)
    clk = clocks()
    plain_ms = cuda_ms(lambda: tpwl_select_plain(*args, k), 5)
    nbytes = (x.element_size() * (B * 2 * r + P * 2 * r + n_rows * row
                                  + (B - k) * row) + 8 * B)
    flops = B * P * (6 * r + 5)
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[{tag}] tpwl_select {str(x.dtype)[6:]} B={B} index_only={k} "
          f"P={P}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}) [{card}; after it SM clock, max, "
          f"power, temperature: {clk}]")
    return dict(B=B, index_only=k, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops, distinct_rows=n_rows, clocks=clk)


def hold_admm(tag, ka, iters):
    """Kernel 1 on a path's recorded launch against its plain version: in
    f64 within ADMM_F64_TOL of the scale; in f32 its error against the
    plain version in f64 on the same inputs within SSM_F32_ROUNDING_RATIO
    x the plain f32 version's, and its difference from the plain f32
    version within the larger of ADMM_F32_TOL and twice the plain
    version's own error (see SSM_F32_ROUNDING_RATIO)."""
    count = admm_batched.launches
    got = admm_batched(*ka, iters)
    check(admm_batched.launches == count + 1,
          "admm_batched did not launch its kernel")
    plain = admm_batched_plain(*ka, iters)
    dt = ka[0].dtype
    tol, ratio = ADMM_F32_TOL, {}
    if dt == torch.float32:
        exact = admm_batched_plain(*[t.double() for t in ka], iters)
        e_k, e_p = (max(float((a.double() - b).abs().max())
                        for a, b in zip(r, exact)) for r in (got, plain))
        ratio = dict(err_vs_f64_kernel=e_k, err_vs_f64_plain=e_p)
        print(f"[admm_batched] {tag} against f64 on the same inputs: kernel "
              f"{e_k:.3e}, plain {e_p:.3e} (limit {SSM_F32_ROUNDING_RATIO}x)")
        check(e_k <= SSM_F32_ROUNDING_RATIO * max(e_p, 1e-30),
              f"{tag}: the kernel's f32 error {e_k} exceeds "
              f"{SSM_F32_ROUNDING_RATIO} x the plain version's {e_p}")
        scale = max(max(float(b.abs().max()) for b in plain), 1.0)
        tol = max(tol, 2.0 * e_p / scale)
    out = compare("admm_batched", f"{tag} {str(dt)[6:]}", got, plain, dt,
                  tol, f64_scaled=True)
    out.update(ratio)
    return out


def closed_loop(tag, ctrl, plant_step, measure, x_plant, xf, n_ticks, dt):
    """n_ticks of ctrl.evaluate against a plant: the commands (n_ticks,
    m), the host ms of each tick that replanned (synchronized), and the
    kernel launches over the loop."""
    us, replan_ms = [], []
    u_prev = np.zeros(ctrl.input_dim)
    reset_counts()
    for k in range(n_ticks):
        n_solves = len(ctrl.solve_times)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = ctrl.evaluate(round(dt * k, 4), measure(x_plant), xf, u_prev)
        torch.cuda.synchronize()
        if len(ctrl.solve_times) > n_solves:
            replan_ms.append(1e3 * (time.perf_counter() - t0))
        x_plant = plant_step(x_plant, u)
        us.append(u)
        u_prev = u
    counts = read_counts()
    check(np.isfinite(np.asarray(us)).all(), f"{tag}: non-finite commands")
    return np.asarray(us), replan_ms, counts


def fallbacks(svc):
    """Count the service's host-adapter fallbacks: wraps svc._solve_host
    on the instance; returns the list the calls go into."""
    calls = []
    real = svc._solve_host

    def counted(*a):
        calls.append(a[0])
        return real(*a)

    svc._solve_host = counted
    return calls


def baseline_runs(tag, build, dev, card, want_per_solve, plant_selects=0):
    """A baseline closed loop (ROMPC or Koopman MPC) built by
    build(dtype, device) -> (ctrl, svc, loop): f32 on the card (timed,
    kernel 1 recorded and held to its plain version on the first QP,
    host-adapter fallbacks counted), f64 on the card and on the CPU; the
    card runs' commands against the CPU run's. The plant may launch
    kernel 2 plant_selects times a tick (the TPWL plant)."""
    out = {}
    res = {}
    for name, dtype, device in (("f32", torch.float32, dev),
                                ("f64", torch.float64, dev),
                                ("cpu", torch.float64, "cpu")):
        ctrl, svc, loop = build(dtype, device)
        fb = fallbacks(svc)
        with recording(batch_mpc, "admm_batched", n=1) as qp:
            us, replan_ms, counts = loop(ctrl)
        n_solves = len(ctrl.solve_times)
        res[name] = us
        print(f"[{tag}] {name}: {len(us)} ticks, {n_solves} replans, "
              f"{len(fb)} host-adapter fallbacks, launches {counts}; "
              f"{np.median(replan_ms):.2f} ms a replan (host clock, median "
              f"of {len(replan_ms)}: "
              f"{', '.join(f'{t:.1f}' for t in replan_ms)}) [{card}]")
        rec = dict(replans=n_solves, fallbacks=len(fb), launches=counts,
                   replan_ms=float(np.median(replan_ms)),
                   replans_ms=replan_ms)
        if name != "cpu":
            # every replan's solve is one query of the fused service (plus
            # the next one the splice sends ahead)
            check(counts["admm_batched"] > 0
                  and counts["admm_batched"] % want_per_solve == 0
                  and counts["tpwl_select"] == plant_selects * len(us)
                  and all(counts[k] == 0 for k in KERNELS
                          if k not in ("admm_batched", "tpwl_select")),
                  f"{tag} {name}: launches {counts}")
            rec["admm_first_qp"] = hold_admm(f"{tag} first QP", qp[0][:8],
                                             qp[0][8])
            if name == "f32":
                out["kernel_row"] = kernel_row(tag, admm_batched, qp[0][:8],
                                               qp[0][8], card, 50)
                out["kernel_row"]["launches"] = counts["admm_batched"]
        out[name] = rec
    for name, tol in (("f64", F64_CPU_AGREE_TOL), ("f32", BASELINE_F32_TOL)):
        d = rel_diff(res[name], res["cpu"])
        out[name]["cpu_rel_diff"] = d
        print(f"[{tag}] {name} card vs f64 CPU commands: rel difference "
              f"{d:.3e} (tol {tol})")
        check(d <= tol, f"{tag} {name}: card vs CPU difference {d}")
    out["launches"] = out["f32"]["launches"]
    return out


def phase_rompc(Cf, Hf, card, dev):
    """ROMPC at examples/diamond_baselines_campaign.py:130-137's settings
    on the campaign's linear ROM (N=20, N_replan=4, Qz = diag(100, 100,
    0), R = 1e-4 I, Qf = 10 Qz, condensed, qp_backend 'pallas'), the
    LinearROM itself as the plant, a figure-8 tip target about the rest
    output; the delay cut from 1 s to BASELINE_DELAY."""
    data = tpwl_to_linear_rom(ARTIFACT)
    dt = 0.01
    tt = dt * np.arange(1500)
    fig8 = np.zeros((len(tt), 3))
    fig8[:, 0] = -15.0 * np.sin(2 * np.pi * tt / 10.0)
    fig8[:, 1] = 7.5 * np.sin(4 * np.pi * tt / 10.0)
    Qz, R = np.diag([100.0, 100.0, 0.0]), 1e-4 * np.eye(4)

    def build(dtype, device):
        lin = LinearROM(data, dt, Cf=Cf, Hf=Hf, device=device)
        svc = LinearMPCService(
            lin, BASELINE_N_ROMPC, dt, QuadraticCost(Q=Qz, R=R, Qf=10 * Qz),
            Target(t=tt, z=fig8), locp_backend="condensed",
            qp_backend="pallas", dtype=dtype)
        H = lin.H.cpu().numpy()
        nx, ny = lin.state_dim, lin.C.shape[0]
        ctrl = ROMPC(lin, QuadraticCost(Q=H.T @ Qz @ H, R=R),
                     QuadraticCost(Q=np.eye(nx), R=np.eye(ny)), dt,
                     N_replan=4, delay=BASELINE_DELAY, wait=True,
                     solver_service=svc)
        x0 = torch.zeros(nx, dtype=torch.float64, device=lin.device)
        xf = to_numpy(lin.rom.x_ref).astype(float)
        step = lambda x, u: lin.update_state(x, torch.as_tensor(
            u, dtype=torch.float64, device=lin.device))
        meas = lambda x: to_numpy(lin.x_to_zfyf(x, yf=True))
        loop = lambda c: closed_loop("rompc", c, step, meas, x0, xf,
                                     BASELINE_TICKS, dt)
        return ctrl, svc, loop

    return baseline_runs("rompc", build, dev, card, 4)


def koopman_training(model64, dev):
    """The recipe's EDMD (tasks/recipes.py:389-418) on a seeded rollout of
    the campaign TPWL dictionary (the FEM plant is not ported): piecewise-
    constant cable tensions in [0, 1500] mN held 0.25 s, the tip output
    z, delay 1, degree 2. Returns the trained arrays and the scaling."""
    dt, m_in = model64.pre_discretized_dt, model64.input_dim
    rng = np.random.default_rng(444)
    hold = int(round(0.25 / dt))
    u_train = np.repeat(rng.uniform(0, 1500, (KOOPMAN_SAMPLES, m_in)),
                        hold, axis=0)
    X, _ = model64.rollout(np.zeros(model64.state_dim), u_train, dt)
    y_train = to_numpy(model64.x_to_zfyf(X[:-1], zf=True))
    ny = y_train.shape[1]
    y_off = y_train.mean(axis=0)
    y_fac = np.maximum(np.abs(y_train - y_off).max(axis=0), 1e-9)
    u_fac = np.maximum(np.abs(u_train).max(axis=0), 1e-9)
    yn, un = (y_train - y_off) / y_fac, u_train / u_fac
    zeta = np.hstack([yn[1:], yn[:-1], un[:-1]])
    A, B, C = train_edmd(zeta, un[1:], degree=2, reg=1e-8, device=dev)
    return dict(A=A, B=B, C=C[:ny], ny=ny, m=m_in, nzeta=zeta.shape[1],
                dt=dt, scale={"y_offset": y_off, "y_factor": y_fac,
                              "u_offset": np.zeros(m_in), "u_factor": u_fac})


def phase_koopman(model64, card, dev):
    """Koopman MPC at the campaign's settings (examples/diamond_baselines_
    campaign.py:154-158, tasks/recipes.py:417-435: delay 1, degree 2, N=10,
    rollout_horizon=4, Qz = 100 I, R = 0.1 I, Qf = 5 Qz, U = [0, 1], dU =
    +-0.08, qp_iters=600, rho_stages=6, condensed, 'pallas'), the model
    trained by train_edmd (koopman_training), the TPWL dictionary as the
    plant, the figure-8 tip target in the training's scaled coordinates;
    the delay cut from 1 s to BASELINE_DELAY."""
    tr = koopman_training(model64, dev)
    dt, ny, m_in = tr["dt"], tr["ny"], tr["m"]
    tt = dt * np.arange(1500)
    z_abs = np.tile(model64.z_ref.cpu().numpy(), (len(tt), 1))
    z_abs[:, 0] += -15.0 * np.sin(2 * np.pi * tt / 10.0)
    z_abs[:, 1] += 7.5 * np.sin(4 * np.pi * tt / 10.0)
    z_scaled = (z_abs - tr["scale"]["y_offset"]) / tr["scale"]["y_factor"]
    Qz, R = 100.0 * np.eye(ny), 1e-1 * np.eye(m_in)
    print(f"[koopman] EDMD on {KOOPMAN_SAMPLES} held inputs: n_lift="
          f"{tr['A'].shape[0]}, nzeta={tr['nzeta']}; QP of n="
          f"{KOOPMAN_N * m_in}")

    def build(dtype, device):
        km = koopman_model_from_arrays(
            tr["A"], tr["B"], tr["C"], n=ny, m=m_in, nzeta=tr["nzeta"],
            delays=1, obs_degree=2, Ts=dt, scale_dict=tr["scale"],
            device=device)
        svc = LinearMPCService(
            km, KOOPMAN_N, dt, QuadraticCost(Q=Qz, R=R, Qf=5 * Qz),
            Target(t=tt, z=z_scaled),
            U=HyperRectangle(np.ones(m_in), np.zeros(m_in)),
            dU=HyperRectangle(0.08 * np.ones(m_in), -0.08 * np.ones(m_in)),
            max_iter=2000, locp_backend="condensed", qp_backend="pallas",
            qp_iters=600, rho_stages=6, dtype=dtype)
        ctrl = KoopmanMPC(km, delay=BASELINE_DELAY, wait=True,
                          solver_service=svc, rollout_horizon=4)
        plant = model64 if device != "cpu" else model64.to(device="cpu")
        x0 = torch.zeros(plant.state_dim, dtype=torch.float64,
                         device=plant.device)
        step = lambda x, u: plant.update_state(x, torch.as_tensor(
            u, dtype=torch.float64, device=plant.device), dt)
        meas = lambda x: to_numpy(plant.x_to_zfyf(x, zf=True))
        loop = lambda c: closed_loop("koopman", c, step, meas, x0, None,
                                     BASELINE_TICKS, dt)
        return ctrl, svc, loop

    return baseline_runs("koopman", build, dev, card, 6, plant_selects=1)


# ---------------------------------------------------------------------------
# Phases 19-21: the host orchestration layer, the closed-loop harness
# driving the policies, observers and LQR family against a plant


class OutputMap:
    """An output or measurement model z = M x on tensors (the recipes'
    linear maps, tasks/recipes.py:_run_and_save)."""

    def __init__(self, M, device):
        self.M = torch.as_tensor(np.array(M), device=device)

    def evaluate(self, x, generator=None):
        return self.M.to(x.dtype) @ x


class LiftedPlant:
    """The campaign's TPWL dictionary lifted to the 9768-dim full state
    through its POD basis, standing in for the tet-FEM plant whose mesh is
    not in the repository: x+ = lift(update_state(project(x), u, dt)),
    one launch of kernel 2 a step on a card."""

    dtype = torch.float64

    def __init__(self, model):
        self.m = model
        self.input_dim = model.input_dim

    @property
    def device(self):
        return self.m.device

    def x_rest(self):
        return self.m.rom.x_ref.to(torch.float64)

    def step(self, x, u, dt):
        rom = self.m.rom
        return rom.lift_x(self.m.update_state(rom.project_x(x),
                                              u.to(self.m.q.dtype), dt))


def timed_ticks(ctrl, sync=True):
    """Wrap ctrl.evaluate on the instance: the host ms of every tick
    (synchronized on a card), whether it replanned (a new solve, or a new
    policy), and kernel 2's launches inside it. Returns the list the
    ticks go into."""
    ticks, real = [], ctrl.evaluate

    def evaluate(*a):
        n0 = len(getattr(ctrl, "solve_times", ()))
        k0 = tpwl_select.launches
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = real(*a)
        if sync:
            torch.cuda.synchronize()
        ticks.append(dict(ms=1e3 * (time.perf_counter() - t0),
                          replan=len(getattr(ctrl, "solve_times", ())) > n0,
                          selects=tpwl_select.launches - k0))
        return u

    ctrl.evaluate = evaluate
    return ticks


def tick_stats(tag, ticks, counts, n_ticks, card):
    """ms a tick and a replan (host clock, medians) and kernel 2's
    launches a tick and a replan, from timed_ticks' records; printed."""
    rep = [t for t in ticks if t["replan"]]
    plain = [t for t in ticks if not t["replan"]]
    med = lambda v: float(np.median(v)) if v else float("nan")
    out = dict(tick_ms=med([t["ms"] for t in ticks]),
               replan_ms=med([t["ms"] for t in rep]),
               other_tick_ms=med([t["ms"] for t in plain]),
               ticks=len(ticks), replans=len(rep),
               selects_a_replan=med([t["selects"] for t in rep]),
               selects_a_tick=med([t["selects"] for t in plain]),
               outside_ticks=counts["tpwl_select"]
               - sum(t["selects"] for t in ticks), launches=counts)
    print(f"[{tag}] {n_ticks} ticks, {out['replans']} replans: "
          f"{out['tick_ms']:.2f} ms a tick (median; {out['other_tick_ms']:.2f}"
          f" without a replan), {out['replan_ms']:.2f} ms a replan (host "
          f"clock); kernel 2 {out['selects_a_tick']:.0f} launches a tick "
          f"without a replan, {out['selects_a_replan']:.0f} a replan, "
          f"{out['outside_ticks']} outside the ticks (the plant; the "
          f"service's first solve where counted); launches {counts} "
          f"[{card}]")
    return out


def chain_models(dev):
    """The committed chain fixture (tests/helpers.py:chain_pipeline(10
    nodes, 4 cables, dt=0.02, threshold 0.5), written by the JAX
    pipeline) on `dev`: (plant, TPWL model pre-discretized at 0.02, Hf,
    Cf)."""
    with np.load(CHAIN_FIXTURE) as f:
        a = unflatten_arrays(f)
    return (surrogate_from_arrays(a["plant"], device=dev),
            model_from_arrays(a["tpwl"], device=dev), a["Hf"], a["Cf"])


def golden_chain_loop(dev):
    """tests/test_golden.py:_run on `dev`, f64: TPWLGuSTO behind
    GuSTOService(N=5, dt=0.04, Qz=200, R=1e-5 I, max_gusto_iters=2,
    convg_thresh=1e-2, the dense backend), the EKF with W = diag(dx_char
    + 1e-8), V = 0.1 I, scp(N_replan=2, delay=0.5, mpc=True), 3 s at
    dt=0.02 through run_closed_loop on the FEM surrogate. Returns (sim
    data, timed ticks, model)."""
    dt = GOLDEN_DT
    plant, model, Hf, Cf = chain_models(dev)
    Qz, R = 200.0 * np.eye(model.H.shape[0]), 1e-5 * np.eye(plant.input_dim)
    t_t = np.arange(0.0, 8.0, dt)
    z_eq = float((to_numpy(plant.x_rest()) @ Hf.T)[0])
    z_t = (z_eq + 0.05 * np.sin(2 * np.pi * t_t / 3.0))[:, None]
    svc = GuSTOService(TPWLGuSTO(model), 5, 2 * dt, Qz, R,
                       to_numpy(model.rom.project_x(model.rom.x_ref)),
                       t=t_t, z=to_numpy(model.zfyf_to_zy(zf=z_t)),
                       max_gusto_iters=2, convg_thresh=1e-2, verbose=0)
    H = to_numpy(model.H)
    dx = to_numpy(model.get_characteristic_dx(dt))
    ctrl = scp(model, QuadraticCost(Q=H.T @ Qz @ H, R=R), dt, N_replan=2,
               observer=DiscreteEKFObserver(model, W=np.diag(dx + 1e-8),
                                            V=0.1 * np.eye(Cf.shape[0])),
               delay=0.5, wait=True, solver_service=svc, mpc=True)
    ticks = timed_ticks(ctrl, sync=torch.device(dev).type == "cuda")
    sim = run_closed_loop(plant, ctrl, sim_duration=3.0, dt=dt,
                          measurement_model=OutputMap(Cf, dev),
                          output_model=OutputMap(Hf, dev))
    return sim, ticks, model


def phase_golden(card, dev):
    """Phase 19: the golden chain loop in f64 on the card through kernel 2,
    held to tests/golden/closed_loop_chain.npz at the golden test's
    tolerances; kernel 2 held to its plain version on its first call of
    each shape and table."""
    reset_counts()
    with recording(select_ops, "_launch", clone=1) as sel:
        sim, ticks, model = golden_chain_loop(dev)
    counts = read_counts()
    check(counts["tpwl_select"] > 0 and all(
        counts[k] == 0 for k in KERNELS if k != "tpwl_select"),
        f"golden chain: launches {counts}")
    out = tick_stats("golden chain", ticks, counts, len(sim["t"]), card)
    ref = np.load(GOLDEN_CHAIN)
    for k, (rtol, atol) in (("z", GOLDEN_Z_TOL), ("u", GOLDEN_U_TOL)):
        got, want = sim[k], ref[k]
        check(got.shape == want.shape, f"golden chain: {k} {got.shape}")
        err = np.abs(got - want)
        lim = atol + rtol * np.abs(want)
        out[f"{k}_max_abs_err"] = float(err.max())
        out[f"{k}_worst_over_limit"] = float((err / lim).max())
        print(f"[golden chain] {k} against the golden fixture: max abs "
              f"difference {err.max():.3e}, worst {out[f'{k}_worst_over_limit']:.3e}"
              f" of the limit (rtol {rtol}, atol {atol})")
        check(bool((err <= lim).all()),
              f"golden chain: {k} misses the golden at step "
              f"{int(np.argmax((err > lim).any(axis=-1)))}")
    out["select"] = hold_path_selects("golden chain", model, sel)
    return out


def campaign_controller(model, dev, N=CAMPAIGN_N):
    """The Diamond campaign's real-time MPC (examples/diamond_tet_
    campaign.py:158-190, tasks/recipes.py:212-268) on a TPWL model:
    GuSTOService(TPWLGuSTO, N, dt=0.01, Qz = diag(100, 100, 0), R = 1e-5 I,
    U = [0, 1500]^4, CAMPAIGN_GUSTO, in the model's dtype), the EKF with
    W = diag(dx_char +
    1e-8), V = 0.1 I, scp(N_replan=2, mpc=True, feedback=True) with a DARE
    gain at every dictionary point; the figure-8 about the rest output."""
    dt = CAMPAIGN_DT
    Qz, R = np.diag([100.0, 100.0, 0.0]), 1e-5 * np.eye(4)
    tt, z_t = campaign_target(to_numpy(model.z_ref))
    svc = GuSTOService(
        TPWLGuSTO(model), N, dt, Qz, R,
        to_numpy(model.rom.project_x(model.rom.x_ref)).astype(float),
        t=tt, z=to_numpy(model.zfyf_to_zy(zf=z_t)).astype(float),
        U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
        dtype=model.q.dtype, **CAMPAIGN_GUSTO)
    H = to_numpy(model.H).astype(float)
    dx = to_numpy(model.get_characteristic_dx(dt)).astype(float)
    obs = DiscreteEKFObserver(model, W=np.diag(dx + 1e-8),
                              V=0.1 * np.eye(model.C.shape[0]))
    return scp(model, QuadraticCost(Q=H.T @ Qz @ H, R=R), dt, N_replan=2,
               observer=obs, delay=CAMPAIGN_DELAY, wait=True,
               solver_service=svc, mpc=True, feedback=True)


def campaign_target(z_eq):
    """The campaign's figure-8 about the rest output z_eq (examples/
    diamond_tet_campaign.py:159-167): (t, z)."""
    tt = np.linspace(0, 10.0, 1000)
    th = np.linspace(0, 2 * np.pi, 1000)
    z = np.tile(np.asarray(z_eq, float), (1000, 1))
    z[:, 0] += -20.0 * np.sin(th) - 5.5
    z[:, 1] += 10.0 * np.sin(2 * th) + 1.5
    return tt, z


def campaign_loop(ctrl, plant_model, dev, n_ticks, Cf, Hf):
    """ctrl against the lifted plant for n_ticks at dt=0.01 through
    run_closed_loop, commands clamped to [0, 1500]; (sim data, timed
    ticks)."""
    ticks = timed_ticks(ctrl, sync=torch.device(dev).type == "cuda")
    sim = run_closed_loop(LiftedPlant(plant_model), ctrl,
                          sim_duration=n_ticks * CAMPAIGN_DT, dt=CAMPAIGN_DT,
                          measurement_model=OutputMap(Cf, dev),
                          output_model=OutputMap(Hf, dev),
                          u_limits=(np.zeros(4), 1500.0 * np.ones(4)))
    check(np.isfinite(sim["u"]).all() and np.isfinite(sim["z"]).all(),
          "campaign loop: non-finite logs")
    return sim, ticks


def loop_rel_diff(got, ref):
    """max over z and u of rel_diff (max abs difference over max(|ref|,
    1))."""
    return max(rel_diff(got["z"], ref["z"]), rel_diff(got["u"], ref["u"]))


def phase_campaign(model64, model, model_cpu, Cf, Hf, card, dev):
    """Phase 20: the campaign's closed loop at full width (P=1087, n_x=60,
    the 9768-dim lifted plant in f64), CAMPAIGN_DELAY then CAMPAIGN_TICKS
    ticks: f32 on the card (timed, kernel 2 recorded, held and timed at
    B=1), f64 on the card and f64 on the CPU; a profiler pass."""
    n_ticks = CAMPAIGN_TICKS + int(round(CAMPAIGN_DELAY / CAMPAIGN_DT))
    out, sims = {}, {}
    for name, mdl, plant, d in (("f32", model, model64, dev),
                                ("f64", model64, model64, dev),
                                ("cpu", model_cpu, model_cpu, "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl = campaign_controller(mdl, d)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_counts()
        with recording(select_ops, "_launch", clone=1) as sel:
            sim, ticks = campaign_loop(ctrl, plant, d, n_ticks, Cf, Hf)
        counts = read_counts()
        sims[name] = (sim, ctrl)
        if name == "cpu":
            continue
        check(counts["tpwl_select"] > 0 and all(
            counts[k] == 0 for k in KERNELS if k != "tpwl_select"),
            f"campaign {name}: launches {counts}")
        rec = tick_stats(f"campaign {name}", ticks, counts, n_ticks, card)
        rec.update(setup_s=setup_s, solves=len(ctrl.solve_times),
                   plan_rejects=int(ctrl.GuSTO.gusto.plan_rejects))
        # the controller's launches on its tables, the plant's on its own
        for who, m in (("controller", mdl), ("plant", plant)):
            calls = [a for a in sel if a[1] is m.q]
            rec[f"select {who}"] = hold_path_selects(
                f"campaign {name} {who}", m, calls)
        if name == "f32":
            x1 = next(a for a in sel if a[0].shape[0] == 1 and a[1] is mdl.q)
            rec["select_row"] = select_row("campaign tick", (
                x1[0],) + tuple(x1[1:8]), 0, card)
            rec["select_row"]["launches"] = counts["tpwl_select"]
        out[name] = rec
    ref = sims["cpu"][0]
    for name, tol in (("f64", F64_CPU_AGREE_TOL), ("f32", CAMPAIGN_F32_TOL)):
        d = loop_rel_diff(sims[name][0], ref)
        out[name]["cpu_rel_diff"] = d
        print(f"[campaign] {name} card vs f64 CPU: z and u rel difference "
              f"{d:.3e} (tol {tol})")
        check(d <= tol, f"campaign {name}: card vs CPU difference {d}")
    K32, K64 = sims["f32"][1].K, sims["f64"][1].K
    out["f32_gain_rel_diff"] = float(np.abs(K32 - K64).max()
                                     / np.abs(K64).max())
    print(f"[campaign] f32 DARE gains against f64 (1087 points, R = 1e-5 I):"
          f" max abs difference over max |K| {out['f32_gain_rel_diff']:.3e}")
    # where the device time of a loop goes: a fresh f32 controller's loop
    # timed, then another's under the profiler
    ctrl = campaign_controller(model, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    campaign_loop(ctrl, model64, dev, n_ticks, Cf, Hf)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    ctrl = campaign_controller(model, dev)
    out["profile"] = profile_device(
        "campaign f32 loop",
        lambda: campaign_loop(ctrl, model64, dev, n_ticks, Cf, Hf), wall)
    out["profile"]["device_ops_a_tick"] = (
        out["profile"]["device_kernel_launches"] / n_ticks)
    out["loop_ms"] = wall
    out["launches"] = out["f32"]["launches"]
    return out


def policy_runs(tag, make, model64, model_cpu, dev, Cf, Hf, card):
    """A policy (make(model, device) -> controller) against the lifted
    plant for POLICY_TICKS after CAMPAIGN_DELAY, in f64 on the card (its
    set-up and policy computations timed) and on the CPU; commands and
    outputs held within F64_CPU_AGREE_TOL."""
    n_ticks = POLICY_TICKS + int(round(CAMPAIGN_DELAY / CAMPAIGN_DT))
    out, sims = {}, {}
    for name, mdl, d in (("f64", model64, dev), ("cpu", model_cpu, "cpu")):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl = make(mdl, d)
        torch.cuda.synchronize()
        setup_ms = 1e3 * (time.perf_counter() - t0)
        setup_counts = read_counts()
        policy_ms, real = [], ctrl.compute_policy

        def timed_policy(*a, _real=real, _ms=policy_ms):
            torch.cuda.synchronize()
            t1, k1 = time.perf_counter(), tpwl_select.launches
            r = _real(*a)
            torch.cuda.synchronize()
            _ms.append((1e3 * (time.perf_counter() - t1),
                        tpwl_select.launches - k1))
            return r

        ctrl.compute_policy = timed_policy
        reset_counts()
        sim, ticks = campaign_loop(ctrl, mdl, d, n_ticks, Cf, Hf)
        counts = read_counts()
        sims[name] = sim
        if name == "cpu":
            continue
        check(counts["tpwl_select"] >= n_ticks and all(
            counts[k] == 0 for k in KERNELS if k != "tpwl_select"),
            f"{tag}: launches {counts}")
        # TrajTracking and the setpoint LQRs compute their policy in the
        # constructor, ilqr at its first tick after the delay
        policy_ms = [(t, k) for t, k in policy_ms if k or t > 0.05] or [
            (setup_ms, setup_counts["tpwl_select"])]
        out.update(setup_ms=setup_ms, launches=counts,
                   policy_ms=[t for t, _ in policy_ms],
                   policy_selects=[k for _, k in policy_ms],
                   tick_ms=float(np.median([t["ms"] for t in ticks])),
                   ctrl=ctrl)
        print(f"[{tag}] f64: the policy computed in "
              f"{out['policy_ms'][0]:.1f} ms with {out['policy_selects'][0]}"
              f" launches of kernel 2 (set-up {setup_ms:.1f} ms), "
              f"{out['tick_ms']:.2f} ms a tick (median); launches over "
              f"{n_ticks} ticks {counts} [{card}]")
    d = loop_rel_diff(sims["f64"], sims["cpu"])
    out["cpu_rel_diff"] = d
    print(f"[{tag}] f64 card vs f64 CPU: z and u rel difference {d:.3e} "
          f"(tol {F64_CPU_AGREE_TOL})")
    check(d <= F64_CPU_AGREE_TOL, f"{tag}: card vs CPU difference {d}")
    return out


def phase_policies(model64, model_cpu, Cf, Hf, card, dev):
    """Phase 21: ilqr (tf = 0.2 s, 20 steps, iLQRConfig defaults, the
    recipe's Qz = diag(100, 100, 0), R = 1e-2 I, Qf = 0; tasks/recipes.py:
    278-300), TrajTracking along a rollout of the dictionary, StateDLQR
    and StateCLQR at a dictionary point, on the campaign model and the
    lifted plant."""
    dt = CAMPAIGN_DT
    H = to_numpy(model64.H).astype(float)
    Qz = np.diag([100.0, 100.0, 0.0])
    tf = ILQR_STEPS * dt
    t_traj = dt * np.arange(ILQR_STEPS + 1)
    tt, z8 = campaign_target(to_numpy(model64.z_ref))
    z_traj = np.stack([np.interp(t_traj, tt, z8[:, j]) for j in range(3)], 1)
    # a dynamically feasible state trajectory: the dictionary rolled out
    # from the reference under smooth cable tensions
    u_traj = np.zeros((ILQR_STEPS + 1, 4))
    u_traj[:, 0] = 400.0 * (1 - np.cos(2 * np.pi * t_traj / tf)) / 2
    u_traj[:, 2] = 200.0 * (1 - np.cos(2 * np.pi * t_traj / tf)) / 2
    x_traj = to_numpy(model_cpu.rollout(np.zeros(model64.state_dim),
                                        u_traj[:-1], dt)[0])
    i = 100
    x_set = to_numpy(torch.cat([model_cpu.v[i], model_cpu.q[i]]))
    setpoint = dict(x=x_set, u=to_numpy(model_cpu.u[i]),
                    A=to_numpy(model_cpu.A_c[i]),
                    B=to_numpy(model_cpu.B_c[i]))
    reg = QuadraticCost(Q=H.T @ Qz @ H + 1e-3 * np.eye(60),
                        R=1e-2 * np.eye(4))
    makers = {
        "ilqr": lambda m, d: ilqr(
            m, QuadraticCost(Q=Qz, R=1e-2 * np.eye(4), Qf=np.zeros((3, 3))),
            Target(t=t_traj, z=z_traj, Hf=Hf), dt=dt, delay=CAMPAIGN_DELAY,
            tf=tf),
        "traj_tracking": lambda m, d: TrajTracking(
            m, reg, Target(t=t_traj, x=x_traj, u=u_traj), dt=dt,
            delay=CAMPAIGN_DELAY),
        "state_dlqr": lambda m, d: StateDLQR(m, reg, Target(**setpoint),
                                             dt=dt, delay=CAMPAIGN_DELAY),
        "state_clqr": lambda m, d: StateCLQR(m, reg, Target(**setpoint),
                                             dt=dt, delay=CAMPAIGN_DELAY),
    }
    out = {}
    for name, make in makers.items():
        if name == "ilqr":
            make = counting_ilqr(make)
        rec = policy_runs(f"policy {name}", make, model64, model_cpu, dev,
                          Cf, Hf, card)
        ctrl = rec.pop("ctrl")
        if name == "ilqr":
            n_it, n_fw = ctrl.policy.iterations, ctrl.policy.forward_passes
            sel = rec["policy_selects"][0]
            rec.update(iterations=n_it, forward_passes=n_fw,
                       selects_an_iteration=sel / max(n_it, 1))
            print(f"[policy ilqr] {n_it} iterations (backward passes), "
                  f"{n_fw} forward passes of {ILQR_STEPS} steps, kernel 2 "
                  f"{sel} launches in the policy computation: "
                  f"{rec['selects_an_iteration']:.1f} an iteration (one a "
                  f"forward step, B=1); {rec['policy_ms'][0]:.1f} ms")
        out[name] = rec
    return out


def counting_ilqr(make):
    """make(m, d) whose iLQR counts its backward and forward passes in
    .iterations and .forward_passes."""
    def wrapped(m, d):
        c = make(m, d)
        pol = c.policy
        pol.iterations = pol.forward_passes = 0
        fw, bw = pol._forward, pol._run_backward

        def forward(*a):
            pol.forward_passes += 1
            return fw(*a)

        def backward(*a):
            pol.iterations += 1
            return bw(*a)

        pol._forward, pol._run_backward = forward, backward
        return c

    return wrapped

# ---------------------------------------------------------------------------
# Phase 22: the Diamond pipeline (robots, sequences, POD, TPWL build, the
# rollout check, run_scp)


@contextlib.contextmanager
def launches_per_call(cls, name):
    """Within the block, the launches of kernel 2 that each call of
    cls.name makes (a list, one count a call)."""
    real = getattr(cls, name)
    seen = []

    def counted(self, *a, **k):
        before = tpwl_select.launches
        out = real(self, *a, **k)
        seen.append(tpwl_select.launches - before)
        return out

    setattr(cls, name, counted)
    try:
        yield seen
    finally:
        setattr(cls, name, real)


def stage_runner(stages):
    """stage(name, fn): fn() with its wall time (device synchronized on
    both sides) recorded in stages[name]."""
    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out
    return stage


def dictionary_steps(robot, model, nbr_samples, seed):
    """The sweep steps of a dictionary's points: the sweep of
    collect_tpwl_data (its excitation, seed and t_step 0.3) projected with
    the model's basis, and the step each point equals (to 1e-12 of the
    states' scale)."""
    u, _ = recipes._lhs_excitation(robot, nbr_samples, 0.3, seed, 1.0)
    xr = to_numpy(model.rom.project_x(recipes._sweep(robot, u)[:-1]))
    pts = np.concatenate((to_numpy(model.v), to_numpy(model.q)), axis=1)
    dist = np.abs(pts[:, None, :] - xr[None, :, :]).max(-1)
    check(bool(np.all(dist.min(1) <= 1e-12 * max(1.0, np.abs(xr).max()))),
          "pipeline: a dictionary point is no state of its sweep")
    return dist.argmin(1)


def diamond_pipeline(device):
    """examples/diamond_pipeline.py's twin (soft_robot_control_tpu_torch/
    examples/diamond_pipeline.py) on `device` in f64: DiamondRobot(
    n_nodes=10), dt 0.02; POD data (15 samples, seed 1), the basis (1e-8,
    'v'), the dictionary (threshold 0.4, 15 samples), the rollout check,
    run_scp (Qz = 200, 5 s after a 0.5 s delay) and the summary. Returns
    the stages' results, wall times and kernel-2 launches."""
    d = os.path.join(PIPE_DIR, f"diamond10_{torch.device(device).type}")
    stages = {}
    timed = stage_runner(stages)
    out = dict(stages=stages)

    def stage(name, fn):
        if name == "rollout_check":
            reset_counts()
            res = timed(name, fn)
            out["rollout_launches"] = read_counts()
        elif name == "run_scp":
            reset_counts()
            with launches_per_call(GuSTOService, "_solve") as per_query:
                res = timed(name, fn)
            out["scp_launches"] = read_counts()
            out["per_query"] = per_query
        else:
            res = timed(name, fn)
        return res

    out.update(pipeline_twin.pipeline(d, device, stage=stage,
                                      log=lambda line: None))
    out["steps"] = dictionary_steps(out["robot"], out["model"], 15, 222)
    return out


def pipe_rel(got, ref):
    """rel_diff of two arrays or tensors of one shape."""
    got, ref = to_numpy(got), to_numpy(ref)
    check(np.shape(got) == np.shape(ref), f"pipeline: shapes "
          f"{np.shape(got)} {np.shape(ref)}")
    return rel_diff(got, ref)


def phase_pipeline_small(card, dev):
    """Phase 22(a): the Diamond pipeline at examples/diamond_pipeline.py's
    settings in f64 on the card, held to the port's f64 CPU run: the same
    r and selected dictionary steps, the snapshots, the basis (up to each
    column's sign), the dictionary, the rollout's z within PIPE_F64_TOL of
    their scale, the closed loop at the golden test's tolerances; kernel 2
    once a rollout step and the launches of each GuSTO query counted."""
    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        runs[name] = diamond_pipeline(device)
        st = runs[name]["stages"]
        print(f"[pipeline 10 nodes] {name} f64 stage wall times (s): "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
              + f" [{card}]")
    c, r = runs["card"], runs["cpu"]
    out = {"stages_s": c["stages"], "cpu_stages_s": r["stages"]}
    n_roll = len(c["check"]["z_rom"]) - 1
    counts = c["rollout_launches"]
    print(f"[pipeline 10 nodes] rollout check: {n_roll} steps, launches "
          f"{counts}")
    check(counts["tpwl_select"] == n_roll and all(
        counts[k] == 0 for k in KERNELS if k != "tpwl_select"),
        f"pipeline: rollout launches {counts}, expected {n_roll} of "
        "tpwl_select")
    q = np.asarray(c["per_query"])
    sim = c["sim"]
    n_solves = len(sim["info"]["solve_times"])
    print(f"[pipeline 10 nodes] run_scp: {len(sim['t'])} ticks, {len(q)} "
          f"GuSTO queries ({n_solves} solves logged), kernel 2 launches a "
          f"query: min {q.min()}, median {np.median(q):.0f}, max {q.max()}; "
          f"the loop's launches {c['scp_launches']}")
    check(len(q) > 0 and q.min() > 0, "pipeline: a GuSTO query launched no "
          "tpwl_select")
    check(all(c["scp_launches"][k] == 0 for k in KERNELS
              if k != "tpwl_select"), "pipeline: run_scp launched an ADMM "
          "kernel")
    out.update(rollout_launches=counts, scp_launches=c["scp_launches"],
               launches_per_query=q.tolist(), queries=len(q))
    # the card's run against the CPU's
    Uc, Ur = c["pod"]["POD_info"]["U"], r["pod"]["POD_info"]["U"]
    check(Uc.shape == Ur.shape, f"pipeline: r {Uc.shape[1]} on the card, "
          f"{Ur.shape[1]} on the CPU")
    sgn = np.sign(np.sum(Uc * Ur, axis=0))
    s2 = np.concatenate((sgn, sgn))
    check(np.array_equal(c["steps"], r["steps"]),
          f"pipeline: selected steps {c['steps']} on the card, "
          f"{r['steps']} on the CPU")
    mc, mr = c["model"], r["model"]
    diffs = {
        "snapshots": max(pipe_rel(np.asarray(c["snap"][k]),
                                  np.asarray(r["snap"][k]))
                         for k in ("q", "v", "q+", "v+")),
        "basis": pipe_rel(Uc * sgn, Ur),
        "A_c": pipe_rel(s2[:, None] * to_numpy(mc.A_c) * s2[None, :],
                        mr.A_c),
        "B_c": pipe_rel(s2[:, None] * to_numpy(mc.B_c), mr.B_c),
        "d_c": pipe_rel(s2 * to_numpy(mc.d_c), mr.d_c),
        "rollout_z": pipe_rel(c["check"]["z_rom"], r["check"]["z_rom"]),
    }
    for k, v in diffs.items():
        print(f"[pipeline 10 nodes] {k}: card vs f64 CPU {v:.3e} of the "
              f"scale (limit {PIPE_F64_TOL})")
        check(v <= PIPE_F64_TOL, f"pipeline: {k} differs by {v}")
    for k, (rtol, atol) in (("z", GOLDEN_Z_TOL), ("u", GOLDEN_U_TOL)):
        got, want = c["sim"][k], r["sim"][k]
        check(got.shape == want.shape, f"pipeline: closed loop {k} shapes")
        worst = float((np.abs(got - want) / (atol + rtol * np.abs(want)))
                      .max())
        print(f"[pipeline 10 nodes] closed loop {k}: card vs f64 CPU, "
              f"worst {worst:.3e} of the limit (rtol {rtol}, atol {atol})")
        check(worst <= 1.0, f"pipeline: closed loop {k} off the CPU run")
        diffs[f"loop_{k}_worst_over_limit"] = worst
    stats = c["summary"]
    print(f"[pipeline 10 nodes] r = {Uc.shape[1]}, {mc.num_points} "
          f"dictionary points at steps {c['steps'].tolist()}; rollout MSE "
          f"{c['check']['mse']:.6e} (rel_err {c['check']['rel_err']:.6e}); "
          f"tracking MSE {stats['tracking']['mse']:.6e}; solve times (s) "
          f"{stats['solve_times']} [{card}]")
    nums = [c["check"]["mse"], c["check"]["rel_err"],
            stats["tracking"]["mse"]] + list(c["stages"].values())
    check(bool(np.isfinite(nums).all()), "pipeline: a non-finite number")
    out.update(diffs=diffs, r=int(Uc.shape[1]), points=mc.num_points,
               steps=c["steps"].tolist(), rollout_mse=c["check"]["mse"],
               rollout_rel_err=c["check"]["rel_err"],
               tracking_mse=stats["tracking"]["mse"],
               solve_times=stats["solve_times"],
               launches={k: v for k, v in c["scp_launches"].items()})
    out["launches"] = {k: counts[k] + c["scp_launches"][k] for k in counts}
    return out


def phase_pipeline_wide(card, dev):
    """Phase 22(b): the offline pipeline at the Diamond mesh's width in f64
    on the card: DiamondRobot(n_nodes=1628), its dt 0.01, the recipes'
    defaults (40 LHS samples, t_step 0.3), the basis at r = 30, the
    dictionary at collect_tpwl_data's defaults, the rollout check at 10
    samples. Each stage's wall time and device-busy share, the plant
    step's time, the dictionary's size, the peak device memory, the
    rollout's rel_err; the first PIPE_WIDE_STEPS steps after the
    excitation starts against the port's f64 CPU run, the basis'
    orthonormality, at least 2 points, every number finite. Kernel 2's
    launches over the pipeline are counted; its first launch (the rollout,
    B=1) is held to its plain version and timed."""
    robot = DiamondRobot(n_nodes=PIPE_WIDE_NODES, device=dev)
    d = os.path.join(PIPE_DIR, f"diamond{PIPE_WIDE_NODES}")
    stages = {}
    stage = stage_runner(stages)
    fns = {
        "pod_data": lambda: recipes.collect_pod_data(robot, d),
        "pod_basis": lambda: recipes.compute_pod_basis(
            d, rom_dim=PIPE_WIDE_R),
        "tpwl_data": lambda: recipes.collect_tpwl_data(robot, d),
        "rollout_check": lambda: recipes.tpwl_rollout_check(
            robot, d, nbr_samples=10),
    }
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with recording(select_ops, "_launch", n=1, clone=1) as sel:
        res = {k: stage(k, f) for k, f in fns.items()}
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    snap, pod, model, chk = (res[k] for k in fns)
    T = len(snap["u"])
    n_roll = len(chk["z_rom"]) - 1
    print(f"[pipeline {PIPE_WIDE_NODES} nodes] f64, state "
          f"{2 * PIPE_WIDE_NODES}, dt {robot.dt}: stage wall times (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; {T} sweep steps, {model.num_points} dictionary points, "
          f"rollout rel_err {chk['rel_err']:.6e} (MSE {chk['mse']:.6e}); "
          f"peak device memory {peak_gb:.3f} GB; launches {counts} "
          f"[{card}]")
    check(counts["tpwl_select"] == n_roll and all(
        counts[k] == 0 for k in KERNELS if k != "tpwl_select"),
        f"pipeline wide: launches {counts}, expected {n_roll} of "
        "tpwl_select")
    out = dict(stages_s=dict(stages), sweep_steps=T,
               points=model.num_points, rollout_rel_err=chk["rel_err"],
               rollout_mse=chk["mse"], peak_device_gb=peak_gb,
               launches=counts)
    # where each stage's time goes: each run once more under the profiler,
    # cut to PIPE_PROFILE_SAMPLES LHS samples (the same steps, fewer of
    # them: the profiler's record of the whole stage, some 600,000 device
    # operations, takes minutes to gather), into a directory of its own
    dp = d + "_profiled"
    few = dict(nbr_samples=PIPE_PROFILE_SAMPLES)
    cut = {
        "pod_data": lambda: recipes.collect_pod_data(robot, dp, **few),
        "pod_basis": lambda: recipes.compute_pod_basis(
            dp, rom_dim=PIPE_WIDE_R),
        "tpwl_data": lambda: recipes.collect_tpwl_data(robot, dp, **few),
        "rollout_check": lambda: recipes.tpwl_rollout_check(robot, dp,
                                                            **few),
    }
    cut_s = {}
    stage_cut = stage_runner(cut_s)
    for k, f in cut.items():
        stage_cut(k, f)
    out["profile"] = {k: profile_device(
        f"pipeline {PIPE_WIDE_NODES} {k} ({PIPE_PROFILE_SAMPLES} samples)",
        f, 1e3 * cut_s[k]) for k, f in cut.items()}
    out["profile_stages_s"] = cut_s
    # the plant's step alone, on the card, at a state of the sweep
    u = np.asarray(snap["u"])
    k0 = int(np.argmax(np.abs(u).sum(1) > 0))
    X = np.concatenate((np.asarray(snap["v"]), np.asarray(snap["q"])), 1)
    x_k = torch.as_tensor(X[k0 + 10], device=dev)
    u_k = torch.as_tensor(u[k0 + 10], device=dev)
    out["plant_step_ms"] = cuda_ms(lambda: robot.plant.step(
        x_k, u_k, robot.dt), 10)
    out["plant_step_host_ms"] = 1e3 * stages["pod_data"] / T
    print(f"[pipeline {PIPE_WIDE_NODES} nodes] plant step "
          f"{out['plant_step_ms']:.4f} ms on the card (device time); "
          f"{out['plant_step_host_ms']:.4f} ms a step of the POD sweep "
          f"(host clock) [{card}]")
    # the first steps after the excitation starts, against the CPU
    cpu = DiamondRobot(n_nodes=PIPE_WIDE_NODES, device="cpu")
    t0 = time.perf_counter()
    Xc = to_numpy(simulate(cpu.plant, X[k0], u[k0:k0 + PIPE_WIDE_STEPS],
                           robot.dt))
    Xnext = np.concatenate((np.asarray(snap["v+"]), np.asarray(snap["q+"])),
                           1)[k0:k0 + PIPE_WIDE_STEPS]
    d_steps = pipe_rel(Xnext, Xc[1:])
    moved = float(np.abs(Xc[-1] - Xc[0]).max())
    print(f"[pipeline {PIPE_WIDE_NODES} nodes] steps {k0 + 1}-"
          f"{k0 + PIPE_WIDE_STEPS} (the first {PIPE_WIDE_STEPS} under "
          f"excitation) against the f64 CPU run: {d_steps:.3e} of the scale "
          f"(limit {PIPE_WIDE_TOL}; the state moved {moved:.3e}); CPU "
          f"{time.perf_counter() - t0:.1f} s")
    check(d_steps <= PIPE_WIDE_TOL, f"pipeline wide: steps off the CPU run "
          f"by {d_steps}")
    U = pod["POD_info"]["U"]
    ortho = float(np.abs(U.T @ U - np.eye(U.shape[1])).max())
    print(f"[pipeline {PIPE_WIDE_NODES} nodes] basis {U.shape}: "
          f"|U^T U - I| {ortho:.3e} (limit {PIPE_ORTHO_TOL})")
    check(U.shape[1] == PIPE_WIDE_R and ortho <= PIPE_ORTHO_TOL,
          f"pipeline wide: basis {U.shape}, orthonormal to {ortho}")
    check(model.num_points >= 2, "pipeline wide: fewer than 2 points")
    nums = ([chk["rel_err"], chk["mse"], peak_gb, out["plant_step_ms"],
             d_steps, ortho] + list(stages.values())
            + [p["device_busy_share"] for p in out["profile"].values()])
    check(bool(np.isfinite(nums).all()) and bool(np.isfinite(X).all()),
          "pipeline wide: a non-finite number or state")
    out.update(first_steps_rel_diff=d_steps, basis_orthonormality=ortho,
               excitation_start=k0)
    # kernel 2's first launch on the path: the rollout's, B=1
    check(len(sel) == 1 and sel[0][0].shape[0] == 1,
          "pipeline wide: no launch of tpwl_select at B=1 recorded")
    a = sel[0]
    out["select"] = hold_select(f"pipeline {PIPE_WIDE_NODES} rollout", a[:8],
                                a[8])
    out["select_row"] = select_row(f"pipeline {PIPE_WIDE_NODES} rollout",
                                   (a[0],) + tuple(a[1:8]), 0, card)
    out["select_row"]["launches"] = counts["tpwl_select"]
    return out



# ---------------------------------------------------------------------------
# Phase 23: the tet-FEM plant (sim/fem_tet.py) and the Diamond tet campaign


def scaled(got, ref):
    """max |got - ref| over max |ref| (tensors or arrays of one shape)."""
    got, ref = to_numpy(got), to_numpy(ref)
    check(np.shape(got) == np.shape(ref), f"tet: shapes {np.shape(got)} "
          f"{np.shape(ref)}")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def on_cpu(plant):
    """The plant's leaves carried to a plant on the CPU."""
    return tet_fem_from_arrays(tet_fem_arrays(plant), device="cpu")


def precond_operator(p):
    """S_q diag(1/S_lam) S_q^T, numpy."""
    return to_numpy((p.S_q / p.S_lam) @ p.S_q.T)


def phase_tet_small(card, dev):
    """Phase 23(a): the box in f64 on the card against the CPU: its build's
    preconditioner operator against the CPU's own build; on the same
    leaves, TET_SMALL_STEPS steps under seeded inputs (PCG iterations of
    each step equal), a batched step of 4 lanes (one at rest: no
    iteration), solve_st_multi and both projections at one point, a
    with_young_scale settle, mode_shapes and a short modal_decay_batch."""
    t0 = time.perf_counter()
    pc = box_plant(fem_tet, device=dev)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    ph = on_cpu(pc)
    diffs = {"operator": scaled(precond_operator(pc),
                                precond_operator(box_plant(fem_tet, device="cpu")))}
    rng = np.random.default_rng(23)
    us = 40.0 * rng.random((TET_SMALL_STEPS, 2))
    xc, xh = pc.x_rest(), ph.x_rest()
    its_c, its_h, traj, worst = [], [], [to_numpy(xh)], 0.0
    for u in us:
        xc, kc = pc.step_iters(xc, torch.as_tensor(u, device=dev), pc.dt)
        xh, kh = ph.step_iters(xh, torch.as_tensor(u), ph.dt)
        its_c.append(int(kc))
        its_h.append(int(kh))
        traj.append(to_numpy(xh))
        worst = max(worst, scaled(xc, xh))
    diffs["steps"] = worst
    print(f"[tet box 45 nodes] {TET_SMALL_STEPS} f64 steps: card vs CPU "
          f"{worst:.3e} of the state's scale; PCG iterations a step, card "
          f"{its_c}, CPU {its_h} [{card}]")
    check(its_c == its_h, "tet box: PCG iterations differ from the CPU's")
    # a batched step: lanes along the run, one at rest with no input
    X = np.stack([traj[10], traj[20], to_numpy(ph.x_rest()), traj[29]])
    Ub = np.stack([us[10], [300.0, 0.0], [0.0, 0.0], us[29]])
    bc, kbc = pc.step_iters(torch.as_tensor(X, device=dev),
                            torch.as_tensor(Ub, device=dev), pc.dt)
    bh, kbh = ph.step_iters(torch.as_tensor(X), torch.as_tensor(Ub), ph.dt)
    alone = [int(ph.step_iters(torch.as_tensor(x), torch.as_tensor(u),
                               ph.dt)[1]) for x, u in zip(X, Ub)]
    diffs["batched_step"] = scaled(bc, bh)
    print(f"[tet box 45 nodes] batched step, B=4 (lane 2 at rest): "
          f"iterations card {kbc.tolist()}, CPU {kbh.tolist()}, each lane "
          f"alone on the CPU {alone} [{card}]")
    # lane 2's rhs is 0 on the CPU (f_int(rest) = 0 exactly); the card's
    # products may leave it a rounding residual worth an iteration
    check(kbh.tolist() == alone and alone[2] == 0 and int(kbc[2]) <= 1
          and all(kbc[i] == kbh[i] for i in (0, 1, 3)),
          "tet box: batched step iterations")
    # solve_st_multi and the projections at one point
    x = torch.as_tensor(traj[20])
    q = x[pc.n_nodes_dof:]
    Bc = rng.normal(size=(pc.n_nodes_dof, 6)) * to_numpy(ph.free_mask)[:, None]
    sols = {}
    for name, p, d in (("card", pc, dev), ("cpu", ph, "cpu")):
        R = p.rotations(q.to(d))
        sols[name] = p.solve_st_multi_iters(torch.as_tensor(Bc, device=d), R,
                                            p.node_rotations(R))
    diffs["solve_st_multi"] = scaled(sols["card"][0], sols["cpu"][0])
    check(int(sols["card"][1]) == int(sols["cpu"][1]),
          "tet box: solve_st_multi iterations")
    U, _ = np.linalg.qr(rng.normal(size=(pc.n_nodes_dof, 4)))
    info = {"U": U, "q_ref": to_numpy(ph.q_eq),
            "v_ref": np.zeros(pc.n_nodes_dof)}
    u1 = torch.as_tensor([30.0, 10.0], dtype=torch.float64)
    proj = {}
    for name, p, d in (("card", pc, dev), ("cpu", ph, "cpu")):
        rom = POD(info, device=d)
        proj[name] = (p.reduced_discrete_dynamics(rom, x.to(d), u1.to(d),
                                                  p.dt)
                      + p.reduced_affine_dynamics(rom, x.to(d), u1.to(d)))
    diffs["projections"] = max(scaled(a, b) for a, b in zip(
        proj["card"], proj["cpu"]))
    # with_young_scale's settle, the modes and a short decay
    yc = with_young_scale(pc, 1.2, alpha=0.8, settle_time=0.1)
    yh = with_young_scale(ph, 1.2, alpha=0.8, settle_time=0.1)
    diffs["young_scale"] = max(scaled(yc.q_eq, yh.q_eq),
                               scaled(yc.S_lam, yh.S_lam))
    wc, mc = mode_shapes(pc, n_modes=4)
    wh, _ = mode_shapes(ph, n_modes=4)
    diffs["mode_frequencies"] = scaled(wc, wh)
    dc = modal_decay_batch(pc, mc[:, :2].T, amplitudes=[2.0], duration=0.1,
                           dt=pc.dt)
    dh = modal_decay_batch(ph, mc[:, :2].T, amplitudes=[2.0], duration=0.1,
                           dt=ph.dt)
    check(sorted(dc) == sorted(dh) and len(dc) == 4, "tet box: decay cases")
    diffs["modal_decay"] = max(scaled(dc[k], dh[k]) for k in dc)
    for k, v in diffs.items():
        print(f"[tet box 45 nodes] {k}: card vs f64 CPU {v:.3e} of the "
              f"scale (limit {TET_SMALL_TOL}) [{card}]")
        check(v <= TET_SMALL_TOL, f"tet box: {k} differs by {v}")
    out.update(diffs=diffs, iterations=its_c, batched_iterations=alone,
               solve_st_multi_iterations=int(sols["card"][1]),
               mode_frequencies=wc.tolist())
    return out


@contextlib.contextmanager
def build_parts():
    """Within the block, the wall seconds of the tet build's parts (the
    element stiffnesses, K0, the step matrix's eigh, the gravity settle),
    summed by part, device synchronized on both sides of each."""
    parts = {}
    names = {"_element_stiffness": "element_stiffness",
             "_assemble_k0": "K0", "_step_factor": "eigh",
             "_settle": "settle"}
    real = {n: getattr(fem_tet, n) for n in names}

    def timed(n):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = real[n](*a, **k)
            torch.cuda.synchronize()
            parts[names[n]] = parts.get(names[n], 0.0) + (
                time.perf_counter() - t0)
            return r
        return run

    for n in names:
        setattr(fem_tet, n, timed(n))
    try:
        yield parts
    finally:
        for n in names:
            setattr(fem_tet, n, real[n])


def tet_step_time(tag, plant, x, u, card):
    """TET_TIMED_STEPS steps of the plant from the state x under u, each
    timed on the host clock (device synchronized): the median and mean ms
    a step; device ms a step and busy share from a profiled pass of
    TET_PROFILED_STEPS; the PCG iterations of the step."""
    its = int(plant.step_iters(x, u, plant.dt)[1])
    times = []
    for _ in range(TET_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plant.step(x, u, plant.dt)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    wall = float(np.median(times)) * TET_PROFILED_STEPS
    prof = profile_device(f"{tag} [{card}]", lambda: [
        plant.step(x, u, plant.dt) for _ in range(TET_PROFILED_STEPS)],
        wall)
    out = dict(ms=float(np.median(times)), mean_ms=float(np.mean(times)),
               steps_timed=TET_TIMED_STEPS,
               device_ms=prof["device_ms"] / TET_PROFILED_STEPS,
               device_busy_share=prof["device_busy_share"],
               device_ops=prof["device_kernel_launches"] / TET_PROFILED_STEPS,
               pcg_iterations=its)
    print(f"[{tag}] {out['ms']:.3f} ms a step (median of {TET_TIMED_STEPS} "
          f"on the host clock; mean {out['mean_ms']:.3f}), "
          f"{out['device_ms']:.3f} ms of device time, "
          f"{out['device_ops']:.0f} device operations, {its} PCG iterations "
          f"[{card}]")
    return out


def tet_wide_robot(path, dev, dtype):
    """DiamondTetRobot on the mesh file in `dtype` on `dev`, the build's
    wall seconds and its parts'."""
    with build_parts() as parts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        robot = DiamondTetRobot(mesh_path=path, cache=False, device=dev,
                                dtype=dtype)
        torch.cuda.synchronize()
    return robot, dict(total=time.perf_counter() - t0, **parts)


def tet_plant_wide(robot, name, card, dev, x_load=None):
    """The plant's step timed from rest and under TET_LOAD mN on cable 0
    (after TET_LOAD_STEPS loaded steps from rest, or at x_load), and
    solve_st_multi at TET_COLUMNS columns there; the loaded run's states
    and iterations."""
    p = robot.plant
    tag = f"tet {p.n_nodes} nodes {name}"
    u0 = torch.zeros(4, dtype=p.dtype, device=dev)
    uL = u0.clone()
    uL[0] = TET_LOAD
    out = {"rest": tet_step_time(f"{tag} step from rest", p, p.x_rest(), u0,
                                 card)}
    x, run, its = p.x_rest(), [], []
    if x_load is None:
        for _ in range(TET_LOAD_STEPS):
            x, k = p.step_iters(x, uL, p.dt)
            run.append(x)
            its.append(int(k))
        print(f"[{tag}] {TET_LOAD_STEPS} steps from rest under "
              f"{TET_LOAD:g} mN on cable 0: PCG iterations {its} [{card}]")
    else:
        x = x_load.to(p.dtype)
    out["loaded"] = tet_step_time(f"{tag} step under {TET_LOAD:g} mN", p, x,
                                  uL, card)
    rng = np.random.default_rng(230)
    Bc = torch.as_tensor(rng.normal(size=(p.n_nodes_dof, TET_COLUMNS)),
                         dtype=p.dtype, device=dev) * p.free_mask[:, None]
    R = p.rotations(x[p.n_nodes_dof:])
    Rn = p.node_rotations(R)
    k = int(p.solve_st_multi_iters(Bc, R, Rn)[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.solve_st_multi(Bc, R, Rn)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    out["solve_st_multi"] = dict(columns=TET_COLUMNS, ms=ms, iterations=k)
    print(f"[{tag}] solve_st_multi, {TET_COLUMNS} columns at the loaded "
          f"state: {ms:.3f} ms (host clock), {k} PCG iterations [{card}]")
    out["load_iterations"] = its
    return out, run, x


def figure8(z_eq, duration):
    """examples/diamond_tet_campaign.py:158-168's figure-8 about z_eq over
    `duration` seconds: (t, z)."""
    tt = np.linspace(0, duration, 1000)
    th = np.linspace(0, 2 * np.pi * duration / 10.0, 1000)
    z = np.tile(np.asarray(z_eq, float), (1000, 1))
    z[:, 0] += -20.0 * np.sin(th) - 5.5
    z[:, 1] += 10.0 * np.sin(2 * th) + 1.5
    return tt, z


def tet_campaign_stages(robot, d, samples, check_samples, sim_duration):
    """The campaign's stages at its --quick settings (TET_CAMPAIGN, sample
    counts and the loop's seconds as given) into directory d, in order:
    name -> fn."""
    c = TET_CAMPAIGN
    Hf = robot.get_output_model()
    tt, z_t = figure8(Hf @ to_numpy(robot.plant.x_rest()), sim_duration)
    return {
        "pod_data": lambda: recipes.collect_pod_data(
            robot, d, nbr_samples=samples, t_step=c["t_step"]),
        "pod_basis": lambda: recipes.compute_pod_basis(
            d, pod_tolerance=c["pod_tol"], pod_type="a",
            rom_dim=c["rom_dim"]),
        "tpwl_data": lambda: recipes.collect_tpwl_data(
            robot, d, threshold=c["threshold"], nbr_samples=samples,
            t_step=c["t_step"], dynamics="discrete", eval_type="distance"),
        "rollout_check": lambda: recipes.tpwl_rollout_check(
            robot, d, nbr_samples=check_samples, seed=c["check_seed"],
            t_step=c["t_step"]),
        "run_scp": lambda: (tt, z_t, recipes.run_scp(
            robot, d, tt, z_t, dt_solver=robot.dt, N=c["N"],
            N_replan=c["N_replan"], Qz=np.diag([100.0, 100.0, 0.0]),
            R=1e-5 * np.eye(4), sim_duration=sim_duration, delay=c["delay"],
            U=HyperRectangle(1500.0 * np.ones(4), np.zeros(4)),
            save_prefix="scp_fig8", max_gusto_iters=0, is_tr_active=False,
            locp_backend="condensed", oneshot_iters=2, plan_bound=60.0)),
    }


def tracking_rmse(sim, tt, z_t, delay):
    """The campaign's score (examples/diamond_tet_campaign.py:200-209): RMS
    of the x-y distance to the delay-shifted target from t = 1 s on."""
    z, t = np.asarray(sim["z"]), np.asarray(sim["t"])
    zt = np.stack([np.interp(t - delay, tt, z_t[:, j]) for j in range(3)],
                  axis=1)
    active = t >= 1.0
    return float(np.sqrt(np.mean(np.sum(
        (z[active][:, :2] - zt[active][:, :2]) ** 2, axis=1))))


def phase_tet_wide(card, dev):
    """Phase 23(b): DiamondTetRobot on the box of the Diamond's width (its
    build split into parts, f64 and f32), the plant step from rest and
    under load in both, solve_st_multi at TET_COLUMNS columns, the f32
    step against f64, the first TET_WIDE_STEPS loaded steps against the
    f64 plant carried to the CPU; then the campaign's --quick stages in
    f64 (wall time, busy share from a profiled pass of each at
    TET_PROFILE_SAMPLES samples), P, the rollout's MSE and rel_err, the
    loop's tracking RMSE and plan rejects, kernel 2's launches a rollout
    step and a query (held to its plain version at each shape of both
    stages, timed at each), the peak memory."""
    pts, tets = make_box_mesh(*TET_BOX, spacing=10.0)
    pts = pts - np.asarray(TET_SHIFT)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "box_diamond_width.vtu")
        write_vtu_ascii(path, pts, tets)
        robot, out["build_f64_s"] = tet_wide_robot(path, dev,
                                                   torch.float64)
        p = robot.plant
        n_fixed = int((p.free_mask == 0).sum()) // 3
        cols = to_numpy(p.H.reshape(-1, 3, 4).sum(0).norm(dim=0))
        print(f"[tet wide] box mesh {TET_BOX} at spacing 10 minus "
              f"{TET_SHIFT} in the Diamond's scene: {p.n_nodes} nodes, "
              f"{p.tets.shape[0]} tets, state {p.state_dim}, {n_fixed} "
              f"fixed nodes, cable columns' net force {cols.round(6)}; "
              f"f64 build (s): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in out["build_f64_s"].items())
              + f" [{card}]")
        check(n_fixed > 0 and np.allclose(cols, 1.0) and p.n_nodes > 1354,
              "tet wide: the box does not fit the Diamond's scene")
        out.update(nodes=p.n_nodes, tets=int(p.tets.shape[0]),
                   fixed_nodes=n_fixed, state_dim=p.state_dim)
        out["f64"], run, x_load = tet_plant_wide(robot, "f64", card, dev)
        r32, out["build_f32_s"] = tet_wide_robot(path, dev, torch.float32)
        print("[tet wide] f32 build (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["build_f32_s"].items())
            + f" [{card}]")
        out["f32"], _, _ = tet_plant_wide(r32, "f32", card, dev, x_load)
    uL = torch.zeros(4, dtype=torch.float64, device=dev)
    uL[0] = TET_LOAD
    x64 = p.step(x_load, uL, p.dt)
    x32 = r32.plant.step(x_load.float(), uL.float(), p.dt)
    out["f32_step_rel_err"] = scaled(x32.double(), x64)
    print(f"[tet wide] f32 step against the f64 step at the loaded state: "
          f"{out['f32_step_rel_err']:.3e} of the state's scale (limit "
          f"{TET_F32_TOL}) [{card}]")
    check(out["f32_step_rel_err"] <= TET_F32_TOL,
          f"tet wide: the f32 step off the f64 step by "
          f"{out['f32_step_rel_err']}")
    del r32
    torch.cuda.empty_cache()
    # the f64 plant carried to the CPU: the first loaded steps
    t0 = time.perf_counter()
    cpu = on_cpu(p)
    xh = cpu.x_rest()
    worst = 0.0
    for k in range(TET_WIDE_STEPS):
        xh = cpu.step(xh, uL.cpu(), cpu.dt)
        worst = max(worst, scaled(run[k], xh))
    del cpu
    out["first_steps_rel_diff"] = worst
    print(f"[tet wide] the first {TET_WIDE_STEPS} steps under "
          f"{TET_LOAD:g} mN against the f64 plant on the CPU: {worst:.3e} "
          f"of the state's scale (limit {TET_WIDE_TOL}); CPU "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    check(worst <= TET_WIDE_TOL, f"tet wide: steps off the CPU by {worst}")
    out["campaign"] = tet_campaign(robot, card, dev)
    return out, robot


def tet_campaign(robot, card, dev):
    """The campaign's --quick stages on the wide robot in f64; see
    phase_tet_wide."""
    c = TET_CAMPAIGN
    fns = tet_campaign_stages(robot, TET_DIR, c["samples"],
                              c["check_samples"], c["sim_duration"])
    stages = {}
    stage = stage_runner(stages)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = {k: stage(k, fns[k]) for k in ("pod_data", "pod_basis",
                                         "tpwl_data")}
    # every launch of kernel 2 recorded, with the dictionary each stage
    # loads (recipes.load_tpwl)
    reset_counts()
    with results_of(recipes, "load_tpwl") as roll_models, recording(
            select_ops, "_launch", clone=1) as sel:
        res["rollout_check"] = stage("rollout_check", fns["rollout_check"])
    roll = read_counts()
    reset_counts()
    with results_of(recipes, "load_tpwl") as scp_models, recording(
            select_ops, "_launch", clone=1) as sel_scp, launches_per_call(
            GuSTOService, "_solve") as per_query:
        tt, z_t, sim = stage("run_scp", fns["run_scp"])
    loop = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    snap, pod, model, chk = (res[k] for k in ("pod_data", "pod_basis",
                                              "tpwl_data", "rollout_check"))
    n_roll = len(chk["z_rom"]) - 1
    q = np.asarray(per_query)
    rmse = tracking_rmse(sim, tt, z_t, c["delay"])
    rejects = int(sim["info"].get("plan_rejects", 0))
    r = pod["POD_info"]["U"].shape[1]
    print(f"[tet campaign] f64, {robot.plant.n_nodes} nodes: stage wall "
          "times (s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    stages.items())
          + f"; {len(snap['u'])} POD sweep steps, r = {r}, P = "
          f"{model.num_points}; rollout MSE {chk['mse']:.6e}, rel_err "
          f"{chk['rel_err']:.6e}; loop tracking RMSE {rmse:.4f} mm, "
          f"{rejects} plan rejects, {len(q)} GuSTO queries; peak device "
          f"memory {peak_gb:.3f} GB [{card}]")
    print(f"[tet campaign] kernel 2: {roll['tpwl_select']} launches in the "
          f"rollout check's {n_roll} steps; a GuSTO query: min {q.min()}, "
          f"median {np.median(q):.0f}, max {q.max()}; the loop's launches "
          f"{loop} [{card}]")
    check(roll["tpwl_select"] == n_roll and all(
        roll[k] == 0 for k in KERNELS if k != "tpwl_select"),
        f"tet campaign: rollout launches {roll}")
    check(len(q) > 0 and q.min() > 0 and all(
        loop[k] == 0 for k in KERNELS if k != "tpwl_select"),
        f"tet campaign: loop launches {loop}")
    nums = [chk["mse"], chk["rel_err"], rmse, peak_gb] + list(stages.values())
    check(bool(np.isfinite(nums).all()) and np.isfinite(sim["z"]).all()
          and model.num_points >= 2 and r == c["rom_dim"],
          "tet campaign: a non-finite number, or r or P off")
    out = dict(stages_s=dict(stages), sweep_steps=len(snap["u"]), r=r,
               points=model.num_points, rollout_mse=chk["mse"],
               rollout_rel_err=chk["rel_err"], tracking_rmse_mm=rmse,
               plan_rejects=rejects, queries=len(q),
               launches_per_query=q.tolist(), rollout_launches=roll,
               loop_launches=loop, peak_device_gb=peak_gb,
               launches={k: roll[k] + loop[k] for k in roll})
    # where each stage's time goes: each once more, cut, timed then under
    # the profiler, into a directory of its own
    few = tet_campaign_stages(robot, TET_DIR + "_profiled",
                              TET_PROFILE_SAMPLES, TET_PROFILE_SAMPLES,
                              TET_PROFILE_SCP_S)
    cut_s = {}
    stage_cut = stage_runner(cut_s)
    out["profile"] = {}
    for k, f in few.items():
        stage_cut(k, f)
        out["profile"][k] = profile_device(
            f"tet campaign {k} (cut: {TET_PROFILE_SAMPLES} samples, "
            f"{TET_PROFILE_SCP_S} s loop) [{card}]", f, 1e3 * cut_s[k])
    out["profile_stages_s"] = cut_s
    # kernel 2 held at each shape and table of both stages (the rollout's
    # B=1, the GuSTO queries' N states), timed at the rollout's and a
    # query's first launch
    check(len(roll_models) == 1 and len(scp_models) == 1
          and len(sel) == roll["tpwl_select"]
          and len(sel_scp) == loop["tpwl_select"],
          "tet campaign: the recorded launches are not the counted ones")
    held = {**hold_path_selects("tet campaign rollout", roll_models[0], sel),
            **hold_path_selects("tet campaign loop", scp_models[0],
                                sel_scp)}
    out["select"] = dict(held=held, max_abs_err=max(
        h["max_abs_err"] for h in held.values()))
    a = sel[0]
    check(a[0].shape[0] == 1, "tet campaign: the rollout's launch is not B=1")
    out["select_row"] = select_row("tet campaign rollout",
                                   (a[0],) + tuple(a[1:8]), 0, card)
    out["select_row"]["launches"] = out["launches"]["tpwl_select"]
    shapes = {}
    for c in sel_scp:
        key = (f"B={c[0].shape[0]} on "
               f"{'A_c' if c[3] is scp_models[0].A_c else 'A_d'}")
        shapes[key] = shapes.get(key, 0) + 1
    out["loop_launch_shapes"] = shapes
    print(f"[tet campaign] the loop's launches of kernel 2 by shape: {shapes}"
          f" [{card}]")
    # timed at the most frequent shape of more than one state (B=1 is the
    # rollout row's, which the EKF's prediction shares)
    key = max((k for k in shapes if not k.startswith("B=1 ")),
              key=shapes.get)
    a = next(c for c in sel_scp if key.startswith(f"B={c[0].shape[0]} ")
             and (c[3] is scp_models[0].A_c) == key.endswith("A_c"))
    out["select_row_query"] = select_row("tet campaign query",
                                         (a[0],) + tuple(a[1:8]), a[8], card)
    out["select_row_query"]["launches"] = loop["tpwl_select"]
    return out


# ---------------------------------------------------------------------------
# Phase 24: the four closed-loop recipes, native SSM identification and the
# utilities on the box of the Diamond's width, f64


@contextlib.contextmanager
def class_ticks(cls):
    """Within the block, each call of cls.evaluate (a controller's tick)
    timed on the host clock with the device synchronized on both sides,
    whether it replanned (its solve_times grew) and kernel 2's launches
    inside it; the controller instance of the first call is kept under
    "ctrl". Yields the list of ticks."""
    had = "evaluate" in cls.__dict__
    real = cls.evaluate
    ticks = []

    def evaluate(self, *a):
        n0 = len(getattr(self, "solve_times", ()))
        k0 = tpwl_select.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = real(self, *a)
        torch.cuda.synchronize()
        ticks.append(dict(ms=1e3 * (time.perf_counter() - t0),
                          replan=len(getattr(self, "solve_times", ())) > n0,
                          selects=tpwl_select.launches - k0, ctrl=self))
        return u

    cls.evaluate = evaluate
    try:
        yield ticks
    finally:
        if had:
            cls.evaluate = real
        else:
            del cls.evaluate


def baseline_figure8(z_eq, dt, duration):
    """examples/diamond_baselines_campaign.py:86-95's figure-8 about z_eq
    (amplitudes 15 and 7.5 mm, period 10 s) over duration + 4 s: (t, z)."""
    tt = np.arange(0, duration + 4.0, dt)
    th = 2 * np.pi * tt / 10.0
    z = np.tile(np.asarray(z_eq, float), (len(tt), 1))
    z[:, 0] += -15.0 * np.sin(th)
    z[:, 1] += 7.5 * np.sin(2 * th)
    return tt, z


def baseline_score(sim, tt, z_t):
    """The baselines campaign's score (:99-111): RMS of the x-y distance to
    the target delayed by RECIPE_DELAY, from t = 2 s on."""
    z, t = np.asarray(sim["z"]), np.asarray(sim["t"])
    zt = np.stack([np.interp(t - RECIPE_DELAY, tt, z_t[:, j])
                   for j in range(z_t.shape[1])], axis=1)
    act = t >= 2.0
    return float(np.sqrt(np.mean(np.sum(
        (z[act][:, :2] - zt[act][:, :2]) ** 2, axis=1))))


def admm_shapes(calls):
    """The recorded launches of kernel 1 by (B, n, m, iterations, dtype):
    {key: (count, first launch's arguments)}."""
    out = {}
    for a in calls:
        key = (a[2].shape[0], a[2].shape[1], a[3].shape[1], a[8],
               str(a[0].dtype)[6:])
        n, first = out.get(key, (0, a))
        out[key] = (n + 1, first)
    return out


def hold_recipe_admm(tag, calls, card):
    """Kernel 1's recorded launches on a recipe's path: the first of each
    shape held to its plain version (hold_admm) and timed; the most
    frequent shape's row returned with the held shapes."""
    shapes = admm_shapes(calls)
    check(bool(shapes), f"{tag}: no launch of admm_batched recorded")
    held = {}
    for key, (n, a) in shapes.items():
        t = f"{tag} B={key[0]} n={key[1]} m={key[2]} {key[3]} iters"
        held[t] = hold_admm(t, a[:8], a[8])
        held[t]["launches"] = n
    key = max(shapes, key=lambda k: shapes[k][0])
    row = kernel_row(tag, admm_batched, shapes[key][1][:8], key[3], card,
                     50)
    row["launches"] = len(calls)
    return dict(held=held, max_abs_err=max(h["max_abs_err"]
                                           for h in held.values()),
                row=row)


def recipe_lti(name, run, card):
    """A recipe over LinearMPCService (ROMPC or Koopman MPC) through
    run(): every launch of kernel 1 recorded, held and timed; ms a tick
    and a replan; launches a replan; the loop's tracking RMSE against the
    delayed target."""
    from soft_robot_control_tpu_torch.control.koopman import KoopmanMPC

    cls = ROMPC if name == "rompc" else KoopmanMPC
    reset_counts()
    t0 = time.perf_counter()
    with recording(batch_mpc, "admm_batched") as qp, class_ticks(
            cls) as ticks, counting(LinearMPCService, "_solve_host") as fb:
        tt, z_t, sim = run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rep = [t for t in ticks if t["replan"]]
    n_solves = len(sim["info"]["solve_times"])
    out = dict(wall_s=wall, launches=counts, replans=len(rep),
               ticks=len(ticks), tracking_rmse_mm=baseline_score(
                   sim, tt, z_t),
               tick_ms=float(np.median([t["ms"] for t in ticks])),
               replan_ms=float(np.median([t["ms"] for t in rep])),
               host_fallbacks=len(fb),
               launches_a_replan=counts["admm_batched"] / max(n_solves, 1))
    print(f"[recipe {name}] {len(ticks)} ticks, {n_solves} replans, "
          f"{len(fb)} host-adapter solves; {out['tick_ms']:.2f} ms a tick, "
          f"{out['replan_ms']:.2f} ms a replan (host clock, medians); "
          f"kernel 1 {out['launches_a_replan']:.2f} launches a replan, "
          f"launches {counts}; tracking RMSE {out['tracking_rmse_mm']:.4f} "
          f"mm; {wall:.1f} s [{card}]")
    check(np.isfinite(sim["z"]).all() and np.isfinite(sim["u"]).all()
          and n_solves > 0 and counts["admm_batched"] > 0
          and all(counts[k] == 0 for k in KERNELS if k != "admm_batched")
          and len(qp) == counts["admm_batched"],
          f"recipe {name}: launches {counts}, {n_solves} replans")
    out["admm"] = hold_recipe_admm(f"recipe {name}", qp, card)
    out["ctrl"] = ticks[0]["ctrl"]
    return out


def recipe_tpwl(name, run, card):
    """A recipe on the TPWL dictionary (iLQR or the open-loop GuSTO)
    through run(): every launch of kernel 2 recorded and the first of each
    shape and table held (hold_path_selects), timed at its most frequent
    shape; the run's result and kernel 2's launches."""
    reset_counts()
    t0 = time.perf_counter()
    with results_of(recipes, "load_tpwl") as models, recording(
            select_ops, "_launch", clone=1) as sel:
        res = run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts["tpwl_select"] > 0 and len(sel) == counts["tpwl_select"]
          and all(counts[k] == 0 for k in KERNELS if k != "tpwl_select")
          and len(models) == 1, f"recipe {name}: launches {counts}")
    held = hold_path_selects(f"recipe {name}", models[0], sel)
    shapes = {}
    for c in sel:
        shapes[c[0].shape[0]] = shapes.get(c[0].shape[0], 0) + 1
    B = max(shapes, key=shapes.get)
    a = next(c for c in sel if c[0].shape[0] == B)
    row = select_row(f"recipe {name}", (a[0],) + tuple(a[1:8]), a[8], card)
    row["launches"] = counts["tpwl_select"]
    print(f"[recipe {name}] kernel 2 launches by batch {shapes}; {wall:.1f}"
          f" s [{card}]")
    return res, dict(wall_s=wall, launches=counts, launch_shapes=shapes,
                     select=dict(held=held, max_abs_err=max(
                         h["max_abs_err"] for h in held.values())),
                     select_row=row)


def phase_recipes(robot, card, dev):
    """Phase 24(a): run_rompc, run_koopman, run_ilqr and run_scp_open_loop
    on the wide f64 robot with phase 23's dictionary (TET_DIR), at the
    baselines campaign's --quick settings (RECIPE_DURATION s on its
    figure-8, RECIPE_DELAY s delay); see the module docstring."""
    from soft_robot_control_tpu_torch.control.koopman import KoopmanMPC
    from soft_robot_control_tpu_torch.lqr.ilqr import iLQR
    from soft_robot_control_tpu_torch.scp.locp import LOCP

    d, dt = TET_DIR, robot.dt
    Hf = robot.get_output_model()
    z_eq = Hf @ to_numpy(robot.plant.x_rest())
    tt, z_t = baseline_figure8(z_eq, dt, RECIPE_DURATION)
    qz = np.diag([100.0, 100.0, 0.0])
    lti = dict(sim_duration=RECIPE_DURATION, delay=RECIPE_DELAY,
               locp_backend="condensed", qp_backend="pallas")
    out = {}
    out["rompc"] = recipe_lti("rompc", lambda: (tt, z_t, recipes.run_rompc(
        robot, d, tt, z_t, N=20, N_replan=4, Qz=qz, R=1e-4 * np.eye(4),
        save_prefix="rompc", **lti)), card)
    out["koopman"] = recipe_lti("koopman", lambda: (
        tt, z_t, recipes.run_koopman(
            robot, d, tt, z_t, delay_embed=1, degree=2, N=10,
            rollout_horizon=4, nbr_samples=16, absolute_targets=True,
            save_prefix="koopman", **lti)), card)

    with class_ticks(ilqr) as ticks, counting(
            ilqr, "compute_policy") as pol, counting(
            iLQR, "_run_backward") as iters:
        sim, rec = recipe_tpwl("ilqr", lambda: recipes.run_ilqr(
            robot, d, tt, z_t, Qz=qz, R=1e-2 * np.eye(4),
            tf=RECIPE_DURATION, sim_duration=RECIPE_DURATION,
            delay=RECIPE_DELAY), card)
    check(len(pol) == 1 and len(iters) > 0 and np.isfinite(sim["z"]).all(),
          f"recipe ilqr: {len(pol)} policies, {len(iters)} iterations")
    rec.update(tracking_rmse_mm=baseline_score(sim, tt, z_t),
               policy_ms=1e3 * pol[0][1], iterations=len(iters),
               tick_ms=float(np.median([t["ms"] for t in ticks])),
               launches_an_iteration=rec["launches"]["tpwl_select"]
               / len(iters))
    print(f"[recipe ilqr] policy over {RECIPE_DURATION:g} s: "
          f"{rec['policy_ms']:.1f} ms, {len(iters)} iLQR iterations, kernel "
          f"2 {rec['launches_an_iteration']:.1f} launches an iteration; "
          f"{rec['tick_ms']:.2f} ms a tick (median of {len(ticks)}); "
          f"tracking RMSE {rec['tracking_rmse_mm']:.4f} mm [{card}]")
    out["ilqr"] = rec

    # the recipe hands z to GuSTO as it is, in the model's coordinates
    # (about the reference, z = H x): the target goes in shifted
    model = recipes.load_tpwl(robot, d)
    z_ref = to_numpy(model.z_ref)
    with counting(LOCP, "solve") as solves:
        res, rec = recipe_tpwl("open_loop", lambda: recipes.run_scp_open_loop(
            robot, d, tt, z_t - z_ref, N=60), card)
    topt, zopt, zr = res["topt"], res["zopt"], res["z_replay"] - z_ref
    t_r = dt * np.arange(len(zr))
    z_plan = np.stack([np.interp(t_r, topt, zopt[:, j]) for j in range(2)],
                      axis=1)
    z_goal = np.stack([np.interp(t_r, tt, z_t[:, j] - z_ref[j])
                       for j in range(2)], axis=1)
    rms = lambda e: float(np.sqrt(np.mean(np.sum(e ** 2, axis=1))))
    rec.update(scp_iterations=len(solves), replay_vs_plan_rms_mm=rms(
        zr[:, :2] - z_plan), replay_vs_target_rms_mm=rms(zr[:, :2] - z_goal),
        locp_ms=float(1e3 * np.median([s for _, s in solves])),
        launches_an_iteration=rec["launches"]["tpwl_select"] / len(solves))
    print(f"[recipe open loop] GuSTO N=60: {len(solves)} LOCP solves "
          f"({rec['locp_ms']:.1f} ms median), kernel 2 "
          f"{rec['launches_an_iteration']:.1f} launches an SCP iteration; "
          f"the replay of {len(zr) - 1} steps against the plan: RMS "
          f"{rec['replay_vs_plan_rms_mm']:.4f} mm, against the target "
          f"{rec['replay_vs_target_rms_mm']:.4f} mm [{card}]")
    check(np.isfinite(zr).all() and np.isfinite(zopt).all(),
          "recipe open loop: non-finite plan or replay")
    out["open_loop"] = rec
    return out


def ssm_data_inputs(dt):
    """examples/diamond_ssm_campaign.py's --quick data: the 4 decay levels
    (each cable alone at SSM_AMP mN), the 4 actuated sines of :134-150
    and the 4 held-out sines of :197-202, each sequence T_act steps."""
    amp = SSM_AMP
    levels = [amp * np.eye(4)[i] for i in range(4)]
    T_act = int(round((SSM_HOLD + SSM_DECAY) / dt))
    tt = dt * np.arange(T_act)
    rng = np.random.default_rng(0)
    acts = []
    for k in range(4):
        u = np.zeros((T_act, 4))
        u[:, k] = 0.5 * amp * (1 + np.sin(2 * np.pi * (0.4 + 0.2 * k) * tt))
        acts.append(u)
    tests = [0.4 * amp * (1 + np.sin(2 * np.pi * 0.45 * tt[:, None]
                                     + rng.uniform(0, 2 * np.pi, 4)[None]))
             for _ in range(4)]
    return levels, acts, tests


def tip_qv_output(num_nodes, node):
    """examples/diamond_ssm_campaign.py:33-41: z = [q_tip; v_tip] of a
    state x = [v; q]."""
    C = np.zeros((6, 6 * num_nodes))
    for k in range(3):
        C[k, 3 * num_nodes + 3 * node + k] = 1.0
        C[3 + k, 3 * node + k] = 1.0
    return C


def phase_ssm_learned(robot, card, dev):
    """Phase 24(b): the Diamond SSM campaign's --quick identification on
    the wide f64 robot (decays, actuated and held-out runs each one batch
    of 4 through the batched PCG step), learn_ssm, both campaign gates
    (printed; only finiteness checked: a stand-in mesh), save_mat and
    from_mat(discr_method='be'), then BatchSSMMPC condensed at B=1 for
    SSM_MPC_WINDOWS windows on a figure-8 about rest, kernel 1 held."""
    from soft_robot_control_tpu_torch.models import ssm_learn
    from soft_robot_control_tpu_torch.tasks.sysid_export import (
        collect_actuated_trajectories, collect_decay_trajectories)

    p, dt = robot.plant, robot.dt
    tip = robot.default_output_nodes[0]
    Hf = tip_qv_output(p.n_nodes, tip)
    levels, acts, tests = ssm_data_inputs(dt)
    out = {}
    stage = stage_runner(out.setdefault("stages_s", {}))
    decays = stage("decays", lambda: collect_decay_trajectories(
        p, Hf, levels, hold_time=SSM_HOLD, decay_time=SSM_DECAY, dt=dt))
    acts_data = stage("actuated", lambda: collect_actuated_trajectories(
        p, Hf, acts, dt=dt))
    n_steps = len(acts[0])
    out["batched_step_ms"] = 1e3 * out["stages_s"]["actuated"] / n_steps
    z_eq = Hf @ to_numpy(p.x_rest())
    out["decay_excursion_mm"] = float(max(
        np.abs(z[:, :3] - z_eq[:3]).max() for _, z in decays))
    # the batched step's PCG iterations of each lane, at the loaded mid
    # point of the actuated runs
    xs = p.x_rest()[None].repeat(4, 1)
    u_mid = torch.as_tensor(np.stack([a[n_steps // 2] for a in acts]),
                            dtype=p.dtype, device=dev)
    for _ in range(20):
        xs = p.step(xs, u_mid, p.dt)
    _, k_lane = p.step_iters(xs, u_mid, p.dt)
    out["pcg_iterations_by_lane"] = [int(v) for v in to_numpy(k_lane)]
    print(f"[ssm learned] {p.n_nodes} nodes, tip node {tip}: decays "
          f"{out['stages_s']['decays']:.2f} s, actuated runs "
          f"{out['stages_s']['actuated']:.2f} s ({len(acts)} lanes x "
          f"{n_steps} steps: {out['batched_step_ms']:.3f} ms a batched step"
          f"); PCG iterations of each lane at a loaded step "
          f"{out['pcg_iterations_by_lane']}; the tip's largest excursion "
          f"in the decays {out['decay_excursion_mm']:.4f} mm [{card}]")
    with recording(ssm_learn, "_ridge_fit") as fits:
        model = stage("fit", lambda: ssm_learn.learn_ssm(
            [z[SSM_SKIP:] for _, z in decays], dt, state_dim=6,
            SSM_order=3, ROM_order=3, n_delay=0, z_ref=z_eq,
            actuated_trajs=[z for z, _ in acts_data],
            input_trajs=[u for _, u in acts_data], ridge=list(SSM_RIDGE),
            joint_fit=True, device=dev))
    out["selected_ridge"] = float(fits[-1][2])
    # gate 1: an unforced decay from 3 mm contracts
    x0 = model.observed_to_reduced(torch.as_tensor(
        np.concatenate([3.0 * np.ones(3), np.zeros(3)]), dtype=model.dtype,
        device=dev))
    xs_stab, _ = model.rollout(x0, torch.zeros((200, 4), dtype=model.dtype,
                                               device=dev), dt)
    n0, nT = (float(torch.linalg.norm(xs_stab[i])) for i in (0, -1))
    # gate 2: the held-out actuated runs' tip prediction
    held = stage("held_out", lambda: collect_actuated_trajectories(
        p, Hf, tests, dt=dt))
    z_ref = to_numpy(model.z_ref)
    rels = []
    for z_true, u_test in held:
        xr0 = model.observed_to_reduced(torch.as_tensor(
            z_true[0] - z_ref, dtype=model.dtype, device=dev))
        xr, _ = model.rollout(xr0, torch.as_tensor(
            u_test[:-1], dtype=model.dtype, device=dev), dt)
        z_pred = to_numpy(model.reduced_to_observed(xr)) + z_ref
        err = np.linalg.norm(z_pred[:, :3] - z_true[:, :3], axis=1)
        motion = np.linalg.norm(z_true[:, :3] - z_true[0, :3], axis=1)
        rels.append(float(np.sqrt(np.mean(err ** 2))
                          / max(motion.max(), 1e-9)))
    lin = np.linalg.eigvals(to_numpy(model.r_coeff)[:, :model.state_dim])
    out["linear_part_max_real_eig"] = float(lin.real.max())
    out.update(decay_norm_0=n0, decay_norm_200=nT,
               stable=bool(np.isfinite(nT) and nT < n0),
               held_out_rel_rms=float(np.mean(rels)), held_out_rels=rels)
    print(f"[ssm learned] fit {out['stages_s']['fit']:.2f} s (host f64), "
          f"ridge selected {out['selected_ridge']:g} of {SSM_RIDGE}; gate 1 "
          f"(the campaign's): |x| {n0:.4f} -> {nT:.4f} over 200 unforced "
          f"steps ({'contracts' if out['stable'] else 'does not contract'}"
          "); "
          f"gate 2: held-out tip rel RMS {out['held_out_rel_rms']:.4f} "
          f"({', '.join(f'{r:.3f}' for r in rels)}; the campaign accepts "
          f"< 0.5); the linear part's largest real eigenvalue "
          f"{out['linear_part_max_real_eig']:.4g} 1/s [{card}]")
    # the gates are the campaign's acceptance on the Diamond mesh; on this
    # stand-in mesh they are read, and the fit is held finite
    check(all(np.isfinite(to_numpy(getattr(model, k))).all()
              for k in ("w_coeff", "v_coeff", "r_coeff", "B_r", "rd_coeff",
                        "Bd_r")), "ssm learned: a non-finite fit")
    # the .mat round trip, then the batched SSM MPC through kernel 1
    path = os.path.join(TET_DIR, "learned_SSM_model.mat")
    ssm_learn.save_mat(model, path)
    mdl = from_mat(path, None, discrete=False, discr_method="be",
                   device=dev)
    check(all(torch.equal(getattr(mdl, k), getattr(model, k))
              for k in ("w_coeff", "r_coeff", "B_r", "z_ref")),
          "ssm learned: the .mat round trip changed the model")
    T = SSM_MPC_WINDOWS * SSM_N_REPLAN + SSM_N + 1
    th = 2 * np.pi * SSM_DT * np.arange(T) / 10.0
    amp = SSM_MPC_SCALE * out["decay_excursion_mm"]
    zz = np.zeros((T, 6))
    zz[:, 0], zz[:, 1] = -amp * np.sin(th), amp * np.sin(2 * th)
    zt = window_targets(zz, SSM_MPC_WINDOWS, SSM_N_REPLAN, SSM_N)[None]
    mpc = make_ssm_mpc(mdl, torch.float64, dev, "condensed")
    run = mpc.build_fused(SSM_MPC_WINDOWS)
    x0 = np.zeros((1, mdl.state_dim))
    reset_counts()
    with recording(batch_mpc, "admm_batched") as qp:
        logs = run(x0, zt)
    torch.cuda.synchronize()
    counts = read_counts()
    want = {k: 0 for k in KERNELS}
    want["admm_batched"] = SSM_MPC_WINDOWS
    check(counts == want, f"ssm learned mpc: launches {counts}")
    out["launches"] = counts
    out["mpc_logs_finite"] = bool(torch.isfinite(logs["z"]).all()
                                  and torch.isfinite(logs["u"]).all())
    check(out["mpc_logs_finite"], "ssm learned mpc: non-finite logs")
    ms = host_ms(lambda: run(x0, zt), 5)
    out["mpc_run_ms"] = float(np.median(ms))
    out["admm"] = hold_recipe_admm("ssm learned mpc", qp, card)
    print(f"[ssm learned] BatchSSMMPC condensed B=1, {SSM_MPC_WINDOWS} "
          f"windows: launches {counts}, {out['mpc_run_ms']:.2f} ms a run "
          f"(host clock, median of 5), logs finite: "
          f"{out['mpc_logs_finite']} [{card}]")
    return out


def phase_utils(rompc_ctrl, card):
    """Phase 24(c): block_time against CUDA events on the ROMPC recipe's
    fused replan (its service's compiled step, no host read), and the
    native IO library built on this machine: a SnapLog and
    parse_matrix_txt round trip."""
    from soft_robot_control_tpu_torch.utils import native
    from soft_robot_control_tpu_torch.utils.timing import block_time

    svc = rompc_ctrl.MPC
    spec = svc.locp.spec
    x0 = np.zeros(spec.n_x)
    args = (torch.as_tensor(1.0 - svc._t_off, dtype=spec.dtype,
                            device=svc.device),
            torch.as_tensor(x0, dtype=spec.dtype, device=svc.device),
            svc._w, svc._y)
    svc._fused_fn(*args)
    bt, ev, done = [], [], []
    for _ in range(UTIL_REPS):
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def fn(s=s, e=e):
            s.record()
            r = svc._fused_fn(*args)
            e.record()
            return r

        bt.append(1e3 * block_time(fn))
        done.append(e.query())
        torch.cuda.synchronize()
        ev.append(s.elapsed_time(e))
    out = dict(block_time_ms=float(np.median(bt)),
               cuda_events_ms=float(np.median(ev)),
               block_time_runs_ms=bt, cuda_events_runs_ms=ev)
    print(f"[utils] block_time of the ROMPC replan's fused step: "
          f"{out['block_time_ms']:.3f} ms, CUDA events of the same calls "
          f"{out['cuda_events_ms']:.3f} ms (medians of {UTIL_REPS}) "
          f"[{card}]")
    # each call: its end event has completed when block_time returns, and
    # block_time spans the events (less the clocks' resolution)
    check(all(done) and all(b >= v - BLOCK_TIME_SLACK_MS
                            for b, v in zip(bt, ev)),
          "utils: block_time returned before the card finished")
    out["native_available"] = native.native_available()
    check(out["native_available"], "utils: the native IO library did not "
          "build")
    rng = np.random.default_rng(24)
    M, recs = rng.normal(size=(40, 37)), rng.normal(size=(123, 9))
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "m.txt")
        with open(mpath, "w") as f:
            f.write("# header\n")
            for row in M:
                f.write("[" + " ".join(f"{v:.17g}" for v in row) + "]\n")
        parsed = native.parse_matrix_txt(mpath, 40, 37, skip_lines=1)
        lpath = os.path.join(tmp, "log.snap")
        with native.SnapLog(lpath, 9) as log:
            log.append(recs[0])
            log.append_many(recs[1:])
        back = native.read_snaplog(lpath)
    out.update(library=native.library_path(),
               matrix_equal=bool(np.array_equal(parsed, M)),
               snaplog_equal=bool(np.array_equal(back, recs)))
    print(f"[utils] native IO library {os.path.relpath(out['library'], HERE)}"
          f": parse_matrix_txt exact {out['matrix_equal']}, SnapLog round "
          f"trip exact {out['snaplog_equal']} [{card}]")
    check(out["matrix_equal"] and out["snaplog_equal"],
          "utils: the native IO round trip differs")
    return out


# ---------------------------------------------------------------------------
# Phase 25: scale-out (parallel/mesh.py) on one card, and the entry points
# that run on committed data (launch.py's and the examples' twins)


def part_row(tag, shards, dev, x, card):
    """One part's launch of kernel 2 as the sharded select makes it (all
    states index-only, with the distances) timed beside its plain version
    and its bound: states and the part's coordinates read once, every
    index and distance written once; per state and point 3 operations a
    coordinate, 2 roots, 3 more."""
    p = shards.parts[0][dev]
    args = (x, p["q"], p["v"], p["A_d"], p["B_d"], p["d_d"],
            shards.dist_w_q, shards.dist_w_v)
    B, (P, r) = x.shape[0], p["q"].shape
    ms = cuda_ms(lambda: tpwl_select(*args, index_only=B, distances=True),
                 50)
    clk = clocks()
    plain_ms = cuda_ms(lambda: tpwl_select_plain(*args, B, True), 5)
    nbytes = x.element_size() * (B * 2 * r + P * 2 * r + B) + 8 * B
    bound_ms, bound_by = bound(nbytes, B * P * (6 * r + 5))
    print(f"[{tag}] tpwl_select part launch {str(x.dtype)[6:]} B={B} "
          f"P={P} index-only with distances: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{card}; "
          f"after it SM clock, max, power, temperature: {clk}]")
    return dict(B=B, P=P, index_only=B, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                clocks=clk)


def phase_sharded_select(model64, model, x64, card, dev):
    """Phase 25(a): the dictionary split over mp = SCALE_MP parts of the
    card: at the plan's B=5120, the tick's B=3072 with index_only=1024 and
    B=1, in f64 and f32, the sharded select's indices and rows identical to
    the unsharded kernel's and mp launches a select; the kernel's distance
    output held to the plain version (SELECT_DIST_TOL); in f32 the sharded
    select and the unsharded launch timed, and one part's launch timed at
    the plan's and the tick's shape beside its bound."""
    out = {"rows": {}}
    shapes = ((N * B_MAIN, 0), ((1 + N_REPLAN) * B_MAIN, B_MAIN), (1, 0))
    dist_err = 0.0
    for mdl in (model64, model):
        dt = mdl.q.dtype
        name = str(dt)[6:]
        dic = (mdl.q, mdl.v, mdl.A_d, mdl.B_d, mdl.d_d, mdl.dist_w_q,
               mdl.dist_w_v)
        for B, k in shapes:
            x = x64[:B].to(dt)
            got = tpwl_select(*((x,) + dic), index_only=k, distances=True)
            ref = tpwl_select(*((x,) + dic), index_only=k)
            plain = tpwl_select_plain(*((x,) + dic), k, distances=True)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got[:4], ref)),
                  f"tpwl_select {name} B={B}: the distance output changed "
                  "the select")
            same = got[0] == plain[0]
            rel = float(((got[4] - plain[4]).abs() / plain[4])[same].max())
            err = float((got[4] - plain[4]).abs()[same].max())
            print(f"[scale-out] tpwl_select {name} B={B} index_only={k}: "
                  f"distance output against the plain version {rel:.3e} "
                  f"relative, {err:.3e} absolute (tol "
                  f"{SELECT_DIST_TOL[dt]}), {int((~same).sum())} index "
                  "differences (near-ties)")
            check(rel <= SELECT_DIST_TOL[dt], f"tpwl_select {name} B={B}: "
                  f"distance {rel} off the plain version's")
            if dt == torch.float32:
                dist_err = max(dist_err, err)
        for mp in SCALE_MP:
            mesh = make_mesh(1, mp, devices=[dev] * mp)
            shards = PointShards(mdl, mesh)
            for B, k in shapes:
                x = x64[:B].to(dt)
                ref = tpwl_select(*((x,) + dic), index_only=k)
                n0 = tpwl_select.launches
                got = shards.select(x, mesh.devices[0], index_only=k)
                torch.cuda.synchronize()
                check(tpwl_select.launches - n0 == mp,
                      f"sharded select mp={mp}: {tpwl_select.launches - n0}"
                      f" launches, expected {mp}")
                check(torch.equal(got[0], ref[0]), f"sharded select {name} "
                      f"mp={mp} B={B}: "
                      f"{int((got[0] != ref[0]).sum())} indices differ")
                check(all(torch.equal(a, b) for a, b in zip(got[1:4],
                                                            ref[1:])),
                      f"sharded select {name} mp={mp} B={B}: rows differ")
                if dt != torch.float32 or B == 1:
                    continue
                tag = f"mp={mp} B={B} index_only={k}"
                ms = cuda_ms(lambda: shards.select(x, mesh.devices[0],
                                                   index_only=k), 20)
                ms1 = cuda_ms(lambda: tpwl_select(*((x,) + dic),
                                                  index_only=k), 20)
                print(f"[scale-out] sharded select f32 {tag}: {ms:.4f} ms "
                      f"(mp launches, the host's read of the owners' "
                      f"counts, the owners' row copies), unsharded launch "
                      f"{ms1:.4f} ms; identical indices, rows bitwise "
                      f"[{card}]")
                out[tag] = dict(ms=ms, unsharded_ms=ms1)
                out["rows"][tag] = part_row(f"scale-out {tag}", shards,
                                               dev, x, card)
    print(f"[scale-out] sharded select: indices identical to the unsharded "
          f"kernel's and rows bitwise at mp={SCALE_MP}, every shape, f64 "
          f"and f32")
    out["distance_max_abs_err_f32"] = dist_err
    return out


def phase_sharded_rollout(model, card, dev):
    """Phase 25(b): sharded_rollout_batch at dp=2 x mp=4 on the dictionary,
    SCALE_ROLL_B states near rest for N steps of smooth admissible inputs,
    f32: each step's indices (every sharded select's) identical to the
    unsharded kernel's at the same states, and the states equal to
    rollout_batch(select='exact') bit for bit."""
    B = SCALE_ROLL_B
    rng = np.random.default_rng(8)
    x0 = torch.as_tensor(0.05 * rng.normal(size=(B, model.state_dim)),
                         dtype=torch.float32, device=dev)
    u = torch.as_tensor(1500.0 * rng.uniform(size=(B, N, model.input_dim)),
                        dtype=torch.float32, device=dev)
    mesh = make_mesh(2, 4, devices=[dev] * 8)
    reset_counts()
    with results_of(mesh_mod.PointShards, "select") as sel:
        X = sharded_rollout_batch(model, x0, u, model.pre_discretized_dt,
                                  mesh)
    torch.cuda.synchronize()
    counts = read_counts()
    ref = rollout_batch(model, x0, u, model.pre_discretized_dt,
                        select="exact")
    half = B // 2
    for t in range(N):
        idx = torch.cat([sel[2 * t][0], sel[2 * t + 1][0]])
        want = tpwl_select(X[:, t], model.q, model.v, model.A_d, model.B_d,
                           model.d_d, model.dist_w_q, model.dist_w_v,
                           index_only=B)[0]
        check(torch.equal(idx, want), f"sharded rollout step {t}: indices "
              "differ")
    check(len(sel) == 2 * N and all(s[0].shape[0] == half for s in sel),
          f"sharded rollout: {len(sel)} selects")
    check(torch.equal(X, ref), "sharded rollout: states differ from "
          "rollout_batch(select='exact')")
    print(f"[scale-out] sharded_rollout_batch dp=2 x mp=4, B={B}, {N} steps:"
          f" indices identical at every step, states equal to "
          f"rollout_batch(select='exact') bit for bit; launches {counts}")
    return dict(B=B, steps=N, launches=counts)


def scaled_runs(tag, run, x0, zt, n_timed):
    """run(x0, x0, zt) once with the launches counted (their count a
    window returned), then n_timed runs on the host clock: windows/s at
    the median."""
    reset_counts()
    logs = run(x0, x0, zt)
    torch.cuda.synchronize()
    counts = read_counts()
    runs_ms = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(x0, x0, zt)
        torch.cuda.synchronize()
        runs_ms.append(1e3 * (time.perf_counter() - t0))
    B = x0.shape[0]
    wps = B * N_WIN / (float(np.median(runs_ms)) / 1e3)
    per_window = {k: v / N_WIN for k, v in counts.items()}
    print(f"[{tag}] {wps:.1f} windows/s (median of {n_timed} runs of "
          f"{N_WIN} windows at B={B}, f32: {float(np.median(runs_ms)):.2f} "
          f"ms; min {min(runs_ms):.2f}, max {max(runs_ms):.2f}); launches a "
          f"window {per_window}")
    return logs, dict(windows_per_s=wps, runs_ms=runs_ms, launches=counts,
                      launches_per_window=per_window)


def phase_sharded_mpc(model64, mpc, zt, cpu_mpc, card, dev):
    """Phase 25(c): the headline condensed loop (phase 7's BatchMPC, B=1024,
    4 windows, f32) through sharded_batch_mpc_fused at dp=4 and
    sharded_batch_mpc_fused_mp at dp=1 x mp=4 and dp=2 x mp=4. The mp-only
    run equals the unsharded run bit for bit (the same batch, the same
    indices, the rows copied). A dp part's loop rounds apart from the
    whole batch's (its batched products and factorizations run at another
    batch size), so the dp runs, like the unsharded run, are held to phase
    7's f32 tolerance, CPU_AGREE_TOL of the z variation, against the
    unsharded loop in f64 on the card (phase 7 holds that one to the f64
    CPU run); kernel 1 4 launches a window a dp part, kernel 2 3 mp a window
    a dp part. Then dp=2 x mp=4 in f64 at B=SCALE_F64_B against the port's
    unsharded f64 CPU run, z and u within SCALE_F64_TOL of their scale."""
    x0 = torch.zeros((B_MAIN, mpc.n_x), dtype=torch.float32, device=dev)
    out = {}
    mpc64 = make_mpc(model64, torch.float64, dev)
    z64 = mpc64.build_fused(N_WIN)(x0.double(), x0.double(), zt)[
        "z"].cpu().numpy()

    def rel_z(z, zr):
        return float(np.linalg.norm(z - zr)
                     / np.linalg.norm(zr - zr.mean(axis=(0, 1))))

    ref, out["unsharded"] = scaled_runs(
        "scale-out unsharded", mpc.build_fused(N_WIN), x0, zt, 5)
    zr = ref["z"].cpu().numpy()
    out["unsharded"]["rel_z_diff_f64"] = rel_z(zr, z64)
    print(f"[scale-out unsharded] f32 against f64 on the card at "
          f"B={B_MAIN}: rel z difference "
          f"{out['unsharded']['rel_z_diff_f64']:.3e} (recorded; phase 7 "
          f"holds its f32 loop at B={B_CPU})")
    T = N_WIN * N_REPLAN
    plans = (("mp", sharded_batch_mpc_fused_mp, 1, 4),
             ("dp", sharded_batch_mpc_fused, 4, 1),
             ("dp_mp", sharded_batch_mpc_fused_mp, 2, 4))
    for name, build_fn, dp, mp in plans:
        tag = f"scale-out dp={dp} x mp={mp}"
        mesh = make_mesh(dp, mp, devices=[dev] * (dp * mp))
        rec = (recording(batch_mpc, "admm_batched", n=4 * N_WIN * dp)
               if name == "dp" else contextlib.nullcontext([]))
        with rec as calls:
            logs, o = scaled_runs(tag, build_fn(mpc, N_WIN, mesh), x0, zt, 3)
        want = {"admm_batched": 4 * N_WIN * dp,
                "tpwl_select": (1 + N_REPLAN) * mp * N_WIN * dp}
        z, u = check_logs(tag, logs, (B_MAIN, T, mpc.n_z),
                          (B_MAIN, T, mpc.n_u), o["launches"], want)
        o["rel_track"] = rel_track(z, zt)
        if name == "mp":
            same = all(torch.equal(logs[k], ref[k]) for k in ("z", "u"))
            print(f"[{tag}] logs {'equal' if same else 'differ from'} the "
                  "unsharded run's bit for bit")
            check(same, f"{tag}: logs differ from the unsharded run")
        else:
            o["rel_z_diff_f64"] = rel_z(z, z64)
            o["rel_z_diff_f32"] = rel_z(z, zr)
            print(f"[{tag}] f32 against the unsharded f64 run on the card: "
                  f"rel z difference {o['rel_z_diff_f64']:.3e} (tol "
                  f"{CPU_AGREE_TOL}); against the unsharded f32 run "
                  f"{o['rel_z_diff_f32']:.3e}")
            check(o["rel_z_diff_f64"] <= CPU_AGREE_TOL,
                  f"{tag}: z off the unsharded f64 run")
        if name == "dp":
            o["admm"] = hold_recipe_admm(tag, calls, card)
        out[name] = o
    # f64: dp=2 x mp=4 on the card against the unsharded run on the CPU
    B = SCALE_F64_B
    x0c = np.zeros((B, mpc.n_x))
    want = cpu_mpc.build_fused(N_WIN)(x0c, x0c, zt[:B])
    reset_counts()
    got = sharded_batch_mpc_fused_mp(
        mpc64, N_WIN, make_mesh(2, 4, devices=[dev] * 8))(x0c, x0c, zt[:B])
    counts = read_counts()
    diffs = {k: rel_diff(got[k].cpu().numpy(), want[k].numpy())
             for k in ("z", "u")}
    print(f"[scale-out dp=2 x mp=4] f64 B={B} card vs the unsharded f64 CPU "
          f"run: z {diffs['z']:.3e}, u {diffs['u']:.3e} of their scale "
          f"(tol {SCALE_F64_TOL}); launches {counts}")
    check(max(diffs.values()) <= SCALE_F64_TOL,
          f"scale-out f64: card vs CPU {diffs}")
    out["f64"] = dict(B=B, rel_diff=diffs, launches=counts)
    return out


def phase_entry_points(card, dev):
    """Phase 25(d): the entry points, each called as a user runs it: the
    launch twin's chain on the surrogate Diamond (f64; run_scp for
    SCALE_SCP_S s), realtime_mpc --campaign diamond --seconds
    SCALE_RT_SECONDS with its real-time gates, batched_serving at B=1024
    without and with --mesh 4, the noisy campaign (its gates, and its
    noise-free error within NOISY_REL of the committed JAX figure) and the
    Dubins demo; launches of each counted."""
    out = {}
    d = os.path.join(HERE, "build", "launch")
    res, t0 = {}, time.perf_counter()
    reset_counts()
    for recipe, extra in (("collect_pod_data", []), ("compute_pod_basis", []),
                          ("collect_tpwl_data", []), ("tpwl_check", []),
                          ("run_scp", ["--duration", str(SCALE_SCP_S)])):
        res[recipe] = launch.main(["diamond", recipe, "--save-dir", d,
                                   "--device", dev.type] + extra)
    nums = [v for r in res.values() for v in r.values()
            if isinstance(v, (int, float))]
    check(bool(np.isfinite(nums).all()), f"launch chain: {res}")
    out["launch"] = dict(results=res, s=time.perf_counter() - t0,
                         launches=read_counts())
    print(f"[entry points] launch chain on the surrogate Diamond: "
          f"{out['launch']['s']:.1f} s, launches {out['launch']['launches']}")

    reset_counts()
    rt = realtime_mpc.main(["--campaign", "diamond", "--seconds",
                            str(SCALE_RT_SECONDS), "--device", dev.type,
                            "--json",
                            os.path.join(HERE, "build", "realtime_mpc.json")])
    counts = read_counts()
    check(not realtime_mpc.realtime_gates(rt), f"real-time gates: {rt}")
    per = {k: v / (rt["n_steps"] + 1) for k, v in counts.items()}
    print(f"[entry points] realtime_mpc --campaign diamond: p50 "
          f"{rt['total_ms_p50']:.3f} ms, p99 {rt['total_ms_p99']:.3f} ms, "
          f"compute mean {rt['compute_ms_mean']:.3f} ms, misses "
          f"{rt['compute_budget_misses']}/{rt['n_steps']} of the "
          f"{rt['deadline_ms']:.0f} ms deadline; launches a dispatch {per} "
          f"[{card}]")
    out["realtime"] = dict(rt, launches_per_dispatch=per)

    out["serving"] = {}
    for mesh in (0, 4):
        reset_counts()
        argv = (["--batch", str(B_MAIN), "--device", dev.type]
                + (["--mesh", "4"] if mesh else []))
        s = batched_serving.main(argv)
        out["serving"][f"mesh={mesh}"] = dict(
            windows_per_s=s["windows_per_s"], first_call_s=s["first_call_s"],
            launches=read_counts())
        print(f"[entry points] batched_serving B={B_MAIN} mesh={mesh}: "
              f"{s['windows_per_s']:.1f} windows/s [{card}]")

    reset_counts()
    noisy = noisy_batch_mpc_campaign.main(
        ["--out", os.path.join(HERE, "build", "noisy_batch_mpc.json"),
         "--device", dev.type])
    with open(os.path.join(HERE, "examples", "diamond_tet",
                           "noisy_batch_mpc.json")) as f:
        jax_free = json.load(f)["noise"]["0.0"]
    free = noisy["noise"]["0.0"]
    gap = abs(free - jax_free) / jax_free
    print(f"[entry points] noisy campaign: {noisy['noise']}; noise-free "
          f"{free:.5f} against the committed JAX figure {jax_free:.5f} "
          f"({gap:.3f} apart, limit {NOISY_REL}); gates hold; launches "
          f"{read_counts()}")
    check(not noisy_batch_mpc_campaign.noisy_gates(noisy),
          f"noisy gates: {noisy}")
    check(gap <= NOISY_REL, f"noisy campaign: noise-free {free} against "
          f"{jax_free}")
    out["noisy"] = dict(noisy, noise_free_gap=gap, launches=read_counts())

    t0 = time.perf_counter()
    x, u, _, t_solve, iters = dubins_gusto.solve(dev, verbose=0)
    s = time.perf_counter() - t0
    print(f"[entry points] dubins_gusto: terminal {np.round(x[-1], 3)}, "
          f"max |du| {np.abs(np.diff(u, axis=0)).max():.3f}, {iters} SCP "
          f"iterations, {s:.2f} s [{card}]")
    check(np.abs(x[-1, :2] - [4.0, 5.0]).max() < 0.2
          and np.abs(np.diff(u, axis=0)).max() <= 0.1 + 1e-6,
          "dubins_gusto: target missed")
    out["dubins"] = dict(s=s, iterations=iters,
                         terminal=x[-1].tolist())
    return out


class PhaseClock:
    """Wall seconds of each phase (or group of short phases), printed as each ends, so that
    a run's time against its limit can be read by phase."""

    def __init__(self):
        self.seconds = {}
        self.tag, self.t0 = None, time.perf_counter()

    def start(self, tag):
        now = time.perf_counter()
        if self.tag is not None:
            self.seconds[self.tag] = now - self.t0
            print(f"[time] phases {self.tag}: {now - self.t0:.1f} s")
        self.tag, self.t0 = tag, now


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    rec = {}
    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rec["card"] = card
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    phase_clock = PhaseClock()

    # 2. build
    rec["build_s"] = build.build_kernels(KERNELS)
    print(f"[build] {', '.join(KERNELS)} for sm_90a in "
          f"{rec['build_s']:.1f} s")
    for name in KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    Cf = linearModel([1354, 726, 139, 1445, 729], 1628).C_dense()
    Hf = linearModel([1354], 1628, vel=False).C_dense()
    model64 = from_tpwl_dict(
        ARTIFACT, params={"dist_weights": {"q": 10.0, "v": 1.0}}, Cf=Cf,
        Hf=Hf, discr_method="be", device=dev).to(dtype=torch.float64)
    model = model64.to(dtype=torch.float32)
    t0 = time.perf_counter()
    mpc = make_mpc(model, torch.float32, dev)
    torch.cuda.synchronize()
    print(f"[model] campaign P={model.num_points}, n_x={model.state_dim}, "
          f"n_u={model.input_dim}, n_y={mpc.n_y}, n_z={mpc.n_z}; BatchMPC "
          f"set-up (1087 DARE gains) {time.perf_counter() - t0:.2f} s")
    mpc_a = make_mpc(model, torch.float32, dev, "A")
    mpc_b = make_mpc(model, torch.float32, dev, "B")
    zt = feasible_targets(model, B_MAIN, N_WIN)
    zt_b = feasible_targets(model, 1, N_WIN_B)[0]

    # states near the dictionary: its points plus seeded noise
    rng = np.random.default_rng(3)
    X_pts = torch.cat([model64.v, model64.q], dim=1)
    pts = torch.as_tensor(rng.integers(0, model.num_points, N * B_MAIN),
                          device=dev)
    noise = torch.as_tensor(rng.normal(size=(N * B_MAIN, model.state_dim)),
                            device=dev)
    x_near = X_pts[pts] + 0.05 * X_pts.std(dim=0) * noise

    phase_clock.start("3-6")
    # 3.-6. every kernel against its plain version
    rec["admm_batched"] = phase_admm(
        admm_batched, make_mpc(model64, torch.float64, dev), mpc, x_near, zt,
        card, (B_MAIN, 1, 3), ADMM_F32_TOL, 50, other_size=(100, 120))
    rec["tpwl_select"] = phase_select(model64, model, x_near, card)
    rec["admm_stream"] = phase_admm(
        admm_stream, make_mpc(model64, torch.float64, dev, "A"), mpc_a,
        x_near, zt, card, (64, 1, 3), SPARSE_F32_TOL, 5, time_f64=True)
    rec["admm_stream"]["plans"] = stream_plans()
    rec["admm_stream"]["range"] = stream_range(card, dev)
    rec["admm_cluster"] = phase_admm(
        admm_cluster, make_mpc(model64, torch.float64, dev, "A",
                               horizon=N_F64_CLUSTER), mpc_a,
        x_near, zt, card, (64, 1, 3), SPARSE_F32_TOL, 5,
        cluster_sizes=(6, 8))
    rec["admm_single"] = phase_single(
        make_mpc(model64, torch.float64, dev, "B"), mpc_b, x_near, zt, card)
    torch.cuda.empty_cache()

    phase_clock.start("7-9")
    # 7.-9. the paths
    none = {"tpwl_select": 1 + N_REPLAN, "admm_batched": 0,
            "admm_cluster": 0, "admm_stream": 0, "admm_single": 0}
    small = {**none, "admm_batched": 4}
    rec["condensed"] = phase_fused("condensed", mpc, model64, zt, card,
                                   small, small, CPU_AGREE_TOL, 10)
    rec["path_a"] = phase_fused(
        "path A", mpc_a, model64, zt, card, {**none, "admm_cluster": 4},
        {**none, "admm_stream": 4}, PATH_A_CPU_AGREE_TOL, 5)
    rec["path_b"] = phase_single_loop(mpc_b, model64, zt_b, card)
    cpu_mpc = rec["condensed"].pop("cpu_mpc")
    rec["path_a"].pop("cpu_mpc")
    torch.cuda.empty_cache()

    phase_clock.start("10-13")
    # 10.-13. GuSTO (fused, both formulations; the real-time query) and the
    # LTI service
    rec["gusto_condensed"] = phase_gusto_fused(
        "gusto condensed", "condensed", model64, model, card, GUSTO_F32_TOL)
    rec["gusto_sparse"] = phase_gusto_fused(
        "gusto sparse", "sparse", model64, model, card, GUSTO_SPARSE_F32_TOL)
    rec["gusto_realtime"] = phase_gusto_realtime(model64, model, card)
    rec["lti"] = phase_lti(Cf, Hf, card, dev)
    torch.cuda.empty_cache()

    phase_clock.start("14")
    # 14. BatchSSMMPC fused (bench.py section 5), trunk timed at B=1024,
    # the Diamond checked at B=64
    for form in ("condensed", "sparse"):
        rec[f"ssm_{form}"] = phase_ssm(f"ssm {form}", "trunk", form, SSM_B,
                                       card, dev, True)
        rec[f"ssm_diamond_{form}"] = phase_ssm(
            f"ssm diamond {form}", "diamond", form, SSM_B_DIAMOND, card, dev,
            False)

    phase_clock.start("15")
    # 15.-18. the stage LOCP (bench.py section 4b), GuSTO's stage backend
    # at N=200, ROMPC and Koopman MPC
    rec["stage_locp"] = phase_stage_locp(model64, card, dev)
    phase_clock.start("16")
    rec["gusto_stage"] = phase_stage_gusto(model64, model, card, dev)
    phase_clock.start("17")
    rec["rompc"] = phase_rompc(Cf, Hf, card, dev)
    phase_clock.start("18")
    rec["koopman"] = phase_koopman(model64, card, dev)
    torch.cuda.empty_cache()

    phase_clock.start("19")
    # 19.-21. the host orchestration layer: the golden chain loop, the
    # campaign's closed loop, the other policies
    rec["golden_chain"] = phase_golden(card, dev)
    phase_clock.start("20")
    model_cpu = from_tpwl_dict(
        ARTIFACT, params={"dist_weights": {"q": 10.0, "v": 1.0}}, Cf=Cf,
        Hf=Hf, discr_method="be", device="cpu").to(dtype=torch.float64)
    rec["campaign_loop"] = phase_campaign(model64, model, model_cpu, Cf, Hf,
                                          card, dev)
    phase_clock.start("21")
    rec["policies"] = phase_policies(model64, model_cpu, Cf, Hf, card, dev)
    torch.cuda.empty_cache()

    phase_clock.start("22a")
    # 22. the Diamond pipeline: examples/diamond_pipeline.py's settings
    # against the CPU, then the offline half at the mesh's width
    rec["pipeline_small"] = phase_pipeline_small(card, dev)
    phase_clock.start("22b")
    rec["pipeline"] = phase_pipeline_wide(card, dev)
    torch.cuda.empty_cache()

    phase_clock.start("23a")
    # 23. the tet-FEM plant: the box against the CPU, then the Diamond's
    # width and the Diamond tet campaign's --quick stages
    rec["tet_small"] = phase_tet_small(card, dev)
    phase_clock.start("23b")
    rec["tet"], tet_robot = phase_tet_wide(card, dev)
    torch.cuda.empty_cache()

    phase_clock.start("24a")
    # 24. the closed-loop recipes, native SSM identification and the
    # utilities on the same robot, with phase 23's dictionary
    rec["recipes"] = phase_recipes(tet_robot, card, dev)
    phase_clock.start("24b")
    rec["ssm_learned"] = phase_ssm_learned(tet_robot, card, dev)
    phase_clock.start("24c")
    rec["utils"] = phase_utils(rec["recipes"]["rompc"].pop("ctrl"), card)
    rec["recipes"]["koopman"].pop("ctrl")
    del tet_robot
    torch.cuda.empty_cache()

    phase_clock.start("25")
    # 25. scale-out on one card: the sharded select, rollout and MPC loops,
    # then the entry points that run on committed data
    rec["scaleout"] = dict(
        select=phase_sharded_select(model64, model, x_near, card, dev),
        rollout=phase_sharded_rollout(model, card, dev),
        mpc=phase_sharded_mpc(model64, mpc, zt, cpu_mpc, card, dev),
        entry=phase_entry_points(card, dev))
    torch.cuda.empty_cache()

    phase_clock.start(None)
    rec["phase_s"] = phase_clock.seconds
    k2 = rec["tpwl_select"]["plan"]
    paths = {"condensed": rec["condensed"]["launches"],
             "path_a": rec["path_a"]["launches"],
             "path_a_f64": rec["path_a"]["launches_f64"],
             "path_b": rec["path_b"]["launches"],
             "gusto_condensed": rec["gusto_condensed"]["launches"],
             "gusto_condensed_f64": rec["gusto_condensed"]["launches_f64"],
             "gusto_sparse": rec["gusto_sparse"]["launches"],
             "gusto_sparse_f64": rec["gusto_sparse"]["launches_f64"],
             "gusto_realtime": rec["gusto_realtime"]["launches"],
             "lti_pallas": rec["lti"]["pallas"]["launches"],
             "lti_xla": rec["lti"]["xla"]["launches"],
             "ssm_condensed": rec["ssm_condensed"]["launches"],
             "ssm_sparse": rec["ssm_sparse"]["launches"],
             "ssm_diamond_condensed": rec["ssm_diamond_condensed"][
                 "launches"],
             "ssm_diamond_sparse": rec["ssm_diamond_sparse"]["launches"],
             "stage_locp_cr": rec["stage_locp"]["cr"]["launches"],
             "stage_locp_scan": rec["stage_locp"]["scan"]["launches"],
             "gusto_stage_diamond": rec["gusto_stage"]["launches"],
             "gusto_stage_diamond_f64": rec["gusto_stage"]["launches_f64"],
             "rompc": rec["rompc"]["launches"],
             "rompc_f64": rec["rompc"]["f64"]["launches"],
             "koopman": rec["koopman"]["launches"],
             "koopman_f64": rec["koopman"]["f64"]["launches"],
             "golden_chain": rec["golden_chain"]["launches"],
             "campaign_loop": rec["campaign_loop"]["launches"],
             "campaign_loop_f64": rec["campaign_loop"]["f64"]["launches"],
             **{f"policy_{k}": v["launches"]
                for k, v in rec["policies"].items()},
             "pipeline_small": rec["pipeline_small"]["launches"],
             "pipeline": rec["pipeline"]["launches"],
             "tet_campaign": rec["tet"]["campaign"]["launches"],
             **{f"recipe_{k}": v["launches"]
                for k, v in rec["recipes"].items()},
             "ssm_learned": rec["ssm_learned"]["launches"],
             "scaleout_rollout": rec["scaleout"]["rollout"]["launches"],
             **{f"scaleout_{k}": rec["scaleout"]["mpc"][k]["launches"]
                for k in ("unsharded", "mp", "dp", "dp_mp")},
             "scaleout_f64": rec["scaleout"]["mpc"]["f64"]["launches"],
             "entry_launch": rec["scaleout"]["entry"]["launch"]["launches"],
             **{f"entry_serving_{k}": v["launches"] for k, v in
                rec["scaleout"]["entry"]["serving"].items()},
             "entry_noisy": rec["scaleout"]["entry"]["noisy"]["launches"]}
    src = "soft_robot_control_tpu_torch/csrc/"
    ref = "soft_robot_control_tpu/ops/"

    def entry(name, replaces, path, err, k):
        """One kernel's record on `path`; `launches` is the count on that
        path, `launches_by_path` the count on each."""
        return {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
                "replaces": ref + replaces, "path": path,
                "launches": paths[path][name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": None}

    ref_of = {"admm_batched": "pallas_admm.py:132",
              "admm_stream": "pallas_admm.py:94"}
    # library_ms: no single PyTorch call computes a fixed-iteration ADMM
    # or a select-then-gather. tpwl_select's max_abs_err is over the
    # gathered rows where the indices agree; phase 4 fails on any index
    # difference that is not a near-tie
    kernels = [
        entry("admm_batched", "pallas_admm.py:132", "condensed",
              rec["admm_batched"][f"float32 B={B_MAIN}"]["max_abs_err"],
              rec["admm_batched"]),
        entry("tpwl_select", "pallas_tpwl.py:24", "condensed",
              rec["tpwl_select"][f"float32 B={N * B_MAIN} index_only=0"][
                  "max_abs_err"], k2),
        entry("admm_stream", "pallas_admm.py:94", "path_a_f64",
              rec["admm_stream"]["float32 B=64"]["max_abs_err"],
              rec["admm_stream"]),
        entry("admm_cluster", "pallas_admm.py:94", "path_a",
              rec["admm_cluster"]["float32 B=64"]["max_abs_err"],
              rec["admm_cluster"]),
        entry("admm_single", "pallas_admm.py:28", "path_b",
              rec["admm_single"]["float32"]["max_abs_err"],
              rec["admm_single"]),
    ]
    # the redesigned kernel 1 and kernel 3 on GuSTO's fused paths and the
    # LTI service step (phases 10, 11, 13)
    for path, name in (("gusto_condensed", "admm_batched"),
                       ("gusto_sparse", "admm_stream")):
        r = rec[path]
        kernels.append(entry(name, ref_of[name], path,
                             r[f"float32 B={GUSTO_B}"]["max_abs_err"],
                             r["kernel_row"]))
    r = rec["lti"]["pallas"]
    kernels.append(entry("admm_batched", ref_of["admm_batched"],
                         "lti_pallas", r["f32 B=1"]["max_abs_err"],
                         r["kernel_row"]))
    # kernel 1 on the BatchSSMMPC path (phase 14), at its two new shapes
    for form in ("condensed", "sparse"):
        r = rec[f"ssm_{form}"]
        kernels.append(entry("admm_batched", "pallas_admm.py:132",
                             f"ssm_{form}",
                             r[f"float32 B={SSM_B}"]["max_abs_err"],
                             r["kernel_row"]))
    # kernel 1 on the ROMPC and Koopman MPC steps (phases 17-18), and
    # kernel 2 at GuSTO's stage linearization (phase 16)
    for path in ("rompc", "koopman"):
        r = rec[path]
        kernels.append(entry("admm_batched", "pallas_admm.py:132", path,
                             r["f32"]["admm_first_qp"]["max_abs_err"],
                             r["kernel_row"]))
    sel = rec["gusto_stage"]["select f32"]
    kernels.append(entry(
        "tpwl_select", "pallas_tpwl.py:24", "gusto_stage_diamond",
        max(v["max_abs_err"] for v in sel.values()),
        rec["gusto_stage"]["select_row"]))
    # kernel 2 at a tick of the campaign's closed loop (phase 20) and at a
    # step of the wide pipeline's rollout check (phase 22)
    r = rec["campaign_loop"]["f32"]
    kernels.append(entry(
        "tpwl_select", "pallas_tpwl.py:24", "campaign_loop",
        max(v["max_abs_err"] for v in r["select controller"].values()),
        r["select_row"]))
    r = rec["pipeline"]
    kernels.append(entry("tpwl_select", "pallas_tpwl.py:24", "pipeline",
                         r["select"]["max_abs_err"], r["select_row"]))
    # and at a step of the tet campaign's rollout check (phase 23; its
    # launches held at the queries' shape too)
    r = rec["tet"]["campaign"]
    kernels.append(entry("tpwl_select", "pallas_tpwl.py:24", "tet_campaign",
                         r["select"]["max_abs_err"], r["select_row"]))
    # phase 24: kernel 1 on the ROMPC and Koopman recipes and the learned
    # SSM's MPC, kernel 2 on the iLQR and open-loop GuSTO recipes (f64)
    for path, r in (("recipe_rompc", rec["recipes"]["rompc"]["admm"]),
                    ("recipe_koopman", rec["recipes"]["koopman"]["admm"]),
                    ("ssm_learned", rec["ssm_learned"]["admm"])):
        kernels.append(entry("admm_batched", "pallas_admm.py:132", path,
                             r["max_abs_err"], r["row"]))
    for name in ("ilqr", "open_loop"):
        r = rec["recipes"][name]
        kernels.append(entry("tpwl_select", "pallas_tpwl.py:24",
                             f"recipe_{name}", r["select"]["max_abs_err"],
                             r["select_row"]))
    # phase 25: kernel 2's part launch on the mp-only loop (mp = 4, the
    # plan's shape) and kernel 1 at a dp part's B=256 on the dp=4 loop
    r = rec["scaleout"]
    kernels.append(entry(
        "tpwl_select", "pallas_tpwl.py:24", "scaleout_mp",
        r["select"]["distance_max_abs_err_f32"],
        r["select"]["rows"][f"mp=4 B={N * B_MAIN} index_only=0"]))
    kernels.append(entry("admm_batched", "pallas_admm.py:132", "scaleout_dp",
                         r["mpc"]["dp"]["admm"]["max_abs_err"],
                         r["mpc"]["dp"]["admm"]["row"]))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")
    rec["kernels"] = kernels
    rec["kernel_rows"] = [rec["gusto_condensed"]["kernel_row"],
                          rec["lti"]["pallas"]["kernel_row"],
                          rec["gusto_sparse"]["kernel_row"],
                          rec["ssm_condensed"]["kernel_row"],
                          rec["ssm_sparse"]["kernel_row"],
                          rec["rompc"]["kernel_row"],
                          rec["koopman"]["kernel_row"],
                          rec["gusto_stage"]["select_row"],
                          rec["campaign_loop"]["f32"]["select_row"],
                          rec["pipeline"]["select_row"],
                          rec["tet"]["campaign"]["select_row"],
                          rec["tet"]["campaign"]["select_row_query"],
                          rec["recipes"]["rompc"]["admm"]["row"],
                          rec["recipes"]["koopman"]["admm"]["row"],
                          rec["ssm_learned"]["admm"]["row"],
                          rec["recipes"]["ilqr"]["select_row"],
                          rec["recipes"]["open_loop"]["select_row"],
                          *r["select"]["rows"].values(),
                          r["mpc"]["dp"]["admm"]["row"]]
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
