"""Problem container (examples/__init__.py): the robot, controller,
measurement and output models, save locations and options of one
experiment, with the same checkDefinition validation. The port's own copy
of the JAX package's tasks/problem.py."""

from __future__ import annotations

import os


class Problem:
    def __init__(self):
        self.Robot = None
        self.ControllerClass = None
        self.controller = None
        self.measurement_model = None
        self.output_model = None
        self.simdata_dir = None
        self.snapshots_dir = None
        self.snapshots = None
        self.opt: dict = {}

    def checkDefinition(self, requires_controller=True):
        """Validation in the spirit of examples/__init__.py:38-56."""
        if self.Robot is None:
            raise RuntimeError("Problem.Robot not defined")
        if requires_controller and self.controller is None:
            raise RuntimeError("Problem.controller not defined")
        if self.simdata_dir is not None:
            os.makedirs(self.simdata_dir, exist_ok=True)
        if self.snapshots_dir is not None:
            os.makedirs(self.snapshots_dir, exist_ok=True)
