from .pipeline import StemVideoPipeline

__all__ = ["StemVideoPipeline"]
