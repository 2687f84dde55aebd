"""The benchmark of soft_robot_control_tpu_torch on one NVIDIA H100.

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once and prints one JSON line. A cell is
`workloads/<cell>.json`: a configuration (`configs/<name>.json`, a
dictionary and the controller's settings), a traffic mix
(`traffic/<name>.json`, read by the driver `entries/<kind>.py`) and the
limits of its correctness check. Per-layer metrics are readers in
`metrics/<name>.py`. The plain reference that decides `correct` is in
`reference/`; it imports nothing of the program.
"""
