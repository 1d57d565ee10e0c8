from .rank2 import rank2_direction_batchminor, rank2_update_batched
from .smallchol import solve_spd_batched, solve_spd_batchminor

__all__ = [
    "rank2_direction_batchminor",
    "rank2_update_batched",
    "solve_spd_batched",
    "solve_spd_batchminor",
]
