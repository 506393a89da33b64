"""Element birth: deposition schedules as activation-time arrays."""
from .spiral import (active_at, newborn_between, ring_activation_times,
                     spiral_activation_times)

__all__ = ["spiral_activation_times", "ring_activation_times", "active_at",
           "newborn_between"]
