from .sum import (
    class_argmax,
    class_score,
    linear_predict,
    masked_sigma,
    onehot_block_t,
)

__all__ = ["class_argmax", "class_score", "linear_predict", "masked_sigma",
           "onehot_block_t"]
