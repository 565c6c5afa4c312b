from .nnls import nnls, nnls_with_intercept
from .lasso import lasso_path, lasso_cv
from .robust import robust_affine_fit_elementwise

__all__ = ["nnls", "nnls_with_intercept", "lasso_path", "lasso_cv",
           "robust_affine_fit_elementwise"]
