"""repro_torch.serve - KV-cache decode serving."""
from .engine import Request, ServeEngine, make_serve_step

__all__ = ["Request", "ServeEngine", "make_serve_step"]
