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
from .data_init import data_based_init
from .factory import init_optimizer
from .keras_optimizers import keras_adadelta, keras_adagrad, keras_adamax, keras_nadam, keras_sgd

__all__ = ["AdamWithWeightnorm", "KerasAdam", "KerasRMSprop", "SGDWithWeightnorm",
           "adam_with_weightnorm", "data_based_init", "init_optimizer", "keras_adadelta",
           "keras_adagrad", "keras_adam", "keras_adamax", "keras_nadam", "keras_rmsprop",
           "keras_sgd", "sgd_with_weightnorm"]
