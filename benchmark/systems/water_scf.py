"""The water configurations whose ``model`` names the program's SCF: the
inputs and the system under test of ``water.py``, with the induced-dipole
solver set from the configuration's ``model.scf`` object (keyword arguments
of ``SCFConfig``) in place of ``SCFConfig.md()``, as a user's script passes
its own ``SCFConfig`` to ``ADMPPmeForce``."""

from __future__ import annotations

from benchmark.systems import water
from benchmark.systems.water import make_system

__all__ = ["make_system", "WaterProgram"]


class WaterProgram(water.WaterProgram):
    """``water.WaterProgram`` under the configuration's ``model.scf``."""

    def __init__(self, system, config, list_cutoff, device):
        from admp_tpu_torch import SCFConfig

        super().__init__(system, config, list_cutoff, device)
        self.pme.scf_config = SCFConfig(**config["model"]["scf"])
        self.pme.refresh_calculators()
