from .oracle import sphere_surface_rmse_mm
from .timing import StageTimer, TimerDatabase

__all__ = ["StageTimer", "TimerDatabase", "sphere_surface_rmse_mm"]
