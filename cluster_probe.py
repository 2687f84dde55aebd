"""Time, alone on the card, what the cluster-resident ADMM kernels are built
from: the cluster barrier and the two mat-vec walks over shared memory.

    python3 cluster_probe.py

Builds soft_robot_control_tpu_torch/csrc/probe/cluster_probe.cu with nvcc
for sm_90a into build/ and runs it (a few seconds on an H100). The source
says what each line of the output is. The numbers explain the design of
csrc/admm_cluster.cuh and the gap between the kernels' times and their
bounds (PERF.md); nothing in the port or in chip_smoke.py needs them.
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "soft_robot_control_tpu_torch", "csrc", "probe",
                      "cluster_probe.cu")


def main():
    nvcc = "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        print("cluster_probe: needs the CUDA toolkit and a Hopper card",
              file=sys.stderr)
        return 2
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    exe = os.path.join(HERE, "build", "cluster_probe")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", exe, SOURCE], check=True)
    print("[card]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
