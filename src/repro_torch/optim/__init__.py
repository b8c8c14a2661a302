"""The port's optimizer (:mod:`.adamw`): AdamW over parameter trees."""
from .adamw import (
    AdamWConfig, adamw_init, adamw_init_specs, adamw_update, global_norm, lr_at,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "lr_at"]
