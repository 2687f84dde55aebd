"""Artifact gate enforcement for campaign scripts.

"Gates green at HEAD" as a structural invariant, not a convention: a
campaign run that fails its own quality gates must not leave the failing
artifacts where a snapshot commit can sweep them in. `enforce_gates` runs
the gate tests and, on failure, QUARANTINES the freshly-written artifacts
into `<out_dir>/rejected/` and restores the last committed (green) versions
with `git checkout --`, so the on-disk state a later `git add` sees is
always the last state that passed.

The reference has no analog (its examples persist unconditionally, e.g.
examples/trunk/trunk.py:213-325 pickles the sim data at the end of every
run); this exists because the closed-loop campaigns are this repo's
acceptance evidence. The gate run's environment sets JAX_PLATFORMS=cpu, as
the JAX package's does, so that gate files that are JAX tests run there
as they do under that package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time


def enforce_gates(test_paths, artifacts, out_dir, k=None):
    """Run gate tests; quarantine + restore artifacts on failure.

    Parameters
    ----------
    test_paths : list[str]
        pytest files (absolute paths) holding the gates for this campaign.
    artifacts : list[str]
        files THIS RUN wrote (absolute paths). On gate failure they are
        moved to `<out_dir>/rejected/<ts>-<name>` and, when git-tracked,
        restored to their last committed contents.
    out_dir : str
        campaign output directory (quarantine lives under it).
    k : str, optional
        pytest -k expression limiting the run to this campaign's gates.

    Returns the pytest return code (0 = green). Never raises.
    """
    cmd = [sys.executable, "-m", "pytest", "-q"] + list(test_paths)
    if k:
        cmd += ["-k", k]
    rc = subprocess.call(cmd, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    if rc == 0:
        return 0

    print("ARTIFACT GATES FAILED — quarantining this run's artifacts",
          flush=True)
    qdir = os.path.join(out_dir, "rejected")
    os.makedirs(qdir, exist_ok=True)
    ts = time.strftime("%Y%m%d-%H%M%S")
    repo = _repo_root(out_dir)
    for path in artifacts:
        if not os.path.exists(path):
            continue
        dest = os.path.join(qdir, f"{ts}-{os.path.basename(path)}")
        shutil.move(path, dest)
        print(f"  quarantined {path} -> {dest}", flush=True)
        if repo and _is_tracked(repo, path):
            subprocess.call(["git", "checkout", "--",
                             os.path.relpath(path, repo)], cwd=repo)
            print(f"  restored last committed {os.path.basename(path)}",
                  flush=True)
    return rc


def _repo_root(start):
    out = subprocess.run(["git", "rev-parse", "--show-toplevel"],
                         cwd=os.path.dirname(os.path.abspath(start)) or ".",
                         capture_output=True, text=True)
    return out.stdout.strip() if out.returncode == 0 else None


def _is_tracked(repo, path):
    return subprocess.run(
        ["git", "ls-files", "--error-unmatch", os.path.relpath(path, repo)],
        cwd=repo, capture_output=True).returncode == 0
