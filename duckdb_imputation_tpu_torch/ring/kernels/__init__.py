from .nb_pallas import nb_grouped_sums, nb_grouped_sums_plain
from .qda_pallas import (
    nb_center,
    nb_tables,
    qda_predict_kernel,
    qda_predict_plain,
    qda_tables,
)
from .sigma_fused import fused_impute_aggregate, fused_impute_aggregate_plain
from .sigma_pallas import (
    masked_gram,
    masked_gram_cols,
    masked_gram_cols_plain,
    masked_gram_plain,
)
from .sigma_pallas_grouped import (
    grouped_gram,
    grouped_gram_plain,
    grouped_gram_presorted,
    grouped_gram_presorted_plain,
    sort_by_group,
    unsorted_group_limit,
)

__all__ = ["fused_impute_aggregate", "fused_impute_aggregate_plain",
           "grouped_gram", "grouped_gram_plain", "grouped_gram_presorted",
           "grouped_gram_presorted_plain", "masked_gram", "masked_gram_cols",
           "masked_gram_cols_plain", "masked_gram_plain", "nb_grouped_sums",
           "nb_grouped_sums_plain", "nb_center", "nb_tables", "qda_predict_kernel",
           "qda_predict_plain",
           "qda_tables", "sort_by_group", "unsorted_group_limit"]
