from .step import (TrainConfig, accumulate_grads, init_all,  # noqa
                   make_train_step, split_microbatches)
