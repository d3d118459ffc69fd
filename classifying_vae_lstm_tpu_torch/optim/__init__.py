from .adamwn import (
    AdamWithWeightnorm,
    KerasAdam,
    KerasRMSprop,
    SGDWithWeightnorm,
    adam_with_weightnorm,
    keras_adam,
    keras_rmsprop,
    sgd_with_weightnorm,
)
from .factory import init_optimizer

__all__ = ["AdamWithWeightnorm", "KerasAdam", "KerasRMSprop", "SGDWithWeightnorm",
           "adam_with_weightnorm", "init_optimizer", "keras_adam", "keras_rmsprop",
           "sgd_with_weightnorm"]
