"""Plain PyTorch reference of what the benchmark's cells compute.

It imports nothing of the program under test (soft_robot_control_tpu_torch)
and nothing of the JAX package: it reads the same raw dictionary files, works
out again everything the program's set-up derives from them (the output and
measurement maps, the DARE gains, the constraint rows), and runs the same
arithmetic as the program's plain paths, in the precision a `Numerics` names.
"""
