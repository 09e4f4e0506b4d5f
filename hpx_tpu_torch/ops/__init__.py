from .stencil import (  # noqa: F401
    fma,
    heat_step,
    heat_step_best,
    heat_step_blocked,
    multistep,
    multistep_fused,
    plain_heat_step_blocked,
    plain_multistep,
)
