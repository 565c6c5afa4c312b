from .preprocess import (
    OXFORD_NPI_COLUMNS,
    NPI_MAXES_DEFAULT,
    clean_case_series,
    forward_fill_npis,
    preprocess_region,
    RegionSeries,
    RegionBatch,
    build_region_batch,
)
from .synthetic import synthetic_regions

__all__ = [
    "OXFORD_NPI_COLUMNS", "NPI_MAXES_DEFAULT",
    "clean_case_series", "forward_fill_npis", "preprocess_region",
    "RegionSeries", "RegionBatch", "build_region_batch",
    "synthetic_regions",
]
