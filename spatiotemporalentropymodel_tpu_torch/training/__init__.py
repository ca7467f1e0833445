from .checkpoints import load_checkpoint

__all__ = ["load_checkpoint"]
