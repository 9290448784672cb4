from .transformer import (Model, init_params, train_loss, prefill,  # noqa
                          decode_step)
