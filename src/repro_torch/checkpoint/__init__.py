from .manager import CheckpointManager, state_leaves  # noqa: F401
