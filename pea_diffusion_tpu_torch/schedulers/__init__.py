from . import common, ddim, ddpm, dpm_solver, euler, lcm
from .common import NoiseScheduleConfig

# Scheduler configs of the reference checkpoints' scheduler/config.json
SD15_SCHEDULE = NoiseScheduleConfig(
    beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
    timestep_spacing="leading", steps_offset=1,
)
SDXL_SCHEDULE = SD15_SCHEDULE

__all__ = ["common", "ddim", "ddpm", "dpm_solver", "euler", "lcm", "NoiseScheduleConfig",
           "SD15_SCHEDULE", "SDXL_SCHEDULE"]
