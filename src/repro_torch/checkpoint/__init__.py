"""The port's checkpoints (:mod:`.manager`), in the JAX package's format."""
from .manager import CheckpointManager, latest_step_dir, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "latest_step_dir", "load_checkpoint", "save_checkpoint"]
