from .sigma_fused import fused_impute_aggregate, fused_impute_aggregate_plain
from .sigma_pallas import masked_gram_cols, masked_gram_cols_plain

__all__ = ["fused_impute_aggregate", "fused_impute_aggregate_plain",
           "masked_gram_cols", "masked_gram_cols_plain"]
