from .pfdr_quadratic import (PFDRResult, PFDRSolveState, VertexProx,
                             pfdr_quadratic_d1)

__all__ = ["PFDRResult", "PFDRSolveState", "VertexProx", "pfdr_quadratic_d1"]
