from .gop import ArraySequence, GOPFrame

__all__ = ["GOPFrame", "ArraySequence"]
