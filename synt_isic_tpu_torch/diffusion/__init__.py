from .schedules import (
    DiffusionSchedule,
    betas_squaredcos_cap_v2,
    betas_linear,
    leading_timesteps,
    spaced_timesteps,
    trailing_timesteps,
)
from .ddpm import DDPMParams, ddpm_step, add_noise
from .ddim import DDIMParams, ddim_step
from .dpm import DPMSolverParams, dpm_solver_step
from .unipc import UniPCParams, unipc_step
from .sampler import DiffusionSampler, SamplerConfig

__all__ = [
    "DiffusionSchedule",
    "betas_squaredcos_cap_v2",
    "betas_linear",
    "leading_timesteps",
    "spaced_timesteps",
    "trailing_timesteps",
    "DDPMParams",
    "ddpm_step",
    "add_noise",
    "DDIMParams",
    "ddim_step",
    "DPMSolverParams",
    "dpm_solver_step",
    "UniPCParams",
    "unipc_step",
    "DiffusionSampler",
    "SamplerConfig",
]
