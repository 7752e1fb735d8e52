"""Shared by tests/test_torch_zone.py, test_torch_demand.py and
test_torch_demand_grad.py: heatx's twin of ``testing.build_thermostat_model``
and blocked <-> zone/surface order helpers.  (Not a test module: pytest
collects ``test_*.py`` only.)
"""

import numpy as np

import bench
from heatx.model.building import IdealHeaterCooler as HxIdealHeaterCooler


def heatx_thermostat_model(uncontrolled: bool = True):
    """``heatx_torch.testing.build_thermostat_model`` on heatx's model classes."""
    m = bench.build_city_model(4, 4)
    m.add_hvac(HxIdealHeaterCooler("t0", ["z0"], heat_setpoint=20.0, cool_setpoint=26.0))
    m.add_hvac(HxIdealHeaterCooler("t1", ["z1"], heat_setpoint=21.0, cool_setpoint=25.0, max_heating=300.0))
    m.add_hvac(HxIdealHeaterCooler("t2", ["z2"], heat_setpoint=19.0, cool_setpoint=23.0, max_cooling=100.0))
    if not uncontrolled:
        m.add_hvac(HxIdealHeaterCooler("t3", ["z3"], heat_setpoint=22.0, cool_setpoint=24.0))
    m.add_mixing("z0", "z1", 0.02, bidirectional=False)
    m.add_mixing("z1", "z0", 0.03, bidirectional=False)
    m.add_mixing("z3", "z2", 0.01, bidirectional=False)
    return m


def lanes(lay, a):
    """[k, S] surface-order rows -> blocked [k, SP]."""
    return np.stack([lay.surfaces_to_blocked(x) for x in a])


def zones(lay, a, fill=0.0):
    """[k, Z] zone-order rows -> blocked [k, NB, ZB]."""
    return np.stack([lay.zones_to_blocked(x, fill=fill) for x in a])


def unzones(lay, Z, a):
    """Blocked [..., NB, ZB] -> zone order [..., Z]."""
    a = np.asarray(a)
    if a.ndim == 2:
        return lay.zones_from_blocked(a, Z)
    return np.stack([lay.zones_from_blocked(x, Z) for x in a])
