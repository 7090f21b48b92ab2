from . import common, ddim, dpm_solver
from .common import NoiseScheduleConfig

# Scheduler config of the reference SDXL checkpoint's scheduler/config.json
SDXL_SCHEDULE = NoiseScheduleConfig(
    beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
    timestep_spacing="leading", steps_offset=1,
)

__all__ = ["common", "ddim", "dpm_solver", "NoiseScheduleConfig", "SDXL_SCHEDULE"]
