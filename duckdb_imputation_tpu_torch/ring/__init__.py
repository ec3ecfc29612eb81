from .sum import (
    class_argmax,
    class_score,
    grouped_sigma,
    lift,
    linear_predict,
    masked_sigma,
    nb_lift,
    onehot_block_t,
    sum_nb_aggs,
    sum_to_nb_agg,
    sum_to_nb_agg_grouped,
    sum_to_triple,
    sum_to_triple_grouped,
    sum_triples,
)
from .triple import (
    NBAgg,
    Triple,
    sigma_from_triple,
    triple_add,
    triple_from_sigma,
    triple_scale,
    triple_sub,
)

__all__ = ["NBAgg", "Triple", "class_argmax", "class_score", "grouped_sigma",
           "lift", "linear_predict", "masked_sigma", "nb_lift",
           "onehot_block_t", "sigma_from_triple", "sum_nb_aggs",
           "sum_to_nb_agg", "sum_to_nb_agg_grouped", "sum_to_triple",
           "sum_to_triple_grouped", "sum_triples", "triple_add",
           "triple_from_sigma", "triple_scale", "triple_sub"]
