"""Element birth: deposition schedules as activation-time arrays, and
moving torch sources."""
from .heat_source import GoldakSource, gaussian_ellipsoid_source, goldak_source
from .layers import (activation_times_from_layer_times,
                     layer_activation_times, track_activation_times)
from .spiral import (active_at, newborn_between, ring_activation_times,
                     spiral_activation_times)

__all__ = ["spiral_activation_times", "ring_activation_times", "active_at",
           "newborn_between", "layer_activation_times",
           "activation_times_from_layer_times", "track_activation_times",
           "GoldakSource", "gaussian_ellipsoid_source", "goldak_source"]
