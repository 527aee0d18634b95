from repro_torch.continuum.orbits import Constellation, GroundSite  # noqa: F401
from repro_torch.continuum.network import ContinuumNetwork  # noqa: F401
from repro_torch.continuum.regions import (GlobalTier, MultiConstellation,  # noqa: F401
                                     RegionSpec, ShellSpec,
                                     multiregion_network, region_sites)
from repro_torch.continuum.session import StateSession  # noqa: F401
from repro_torch.continuum.storage import TwoTierStorage  # noqa: F401
