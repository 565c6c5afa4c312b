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
from .synthetic import (synthetic_regions, synthetic_oxford_frame,
                        realistic_oxford_frame, to_oxcgrt_latest_schema,
                        write_oxford_csvs)
from .oxford import (OXCGRT_LATEST_COLUMNS, OxfordTable, load_oxford_data,
                     load_populations, load_geo_list, load_npi_costs,
                     region_arrays)
from .xprize_io import (write_predictions_csv, write_prescriptions_csv,
                        read_future_ip)

__all__ = [
    "OXFORD_NPI_COLUMNS", "NPI_MAXES_DEFAULT",
    "clean_case_series", "forward_fill_npis", "preprocess_region",
    "RegionSeries", "RegionBatch", "build_region_batch",
    "synthetic_regions", "synthetic_oxford_frame", "realistic_oxford_frame",
    "to_oxcgrt_latest_schema", "write_oxford_csvs",
    "OXCGRT_LATEST_COLUMNS", "OxfordTable", "load_oxford_data",
    "load_populations", "load_geo_list", "load_npi_costs", "region_arrays",
    "write_predictions_csv", "write_prescriptions_csv", "read_future_ip",
]
