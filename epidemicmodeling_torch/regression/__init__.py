from .nnls import nnls, nnls_with_intercept

__all__ = ["nnls", "nnls_with_intercept"]
