from .sharding import activation_rules, batch_sharding, param_shardings  # noqa: F401
from .step import (TrainOptions, TrainState, build_prefill_step,  # noqa: F401
                   build_serve_step, build_train_step, init_train_state,
                   loss_and_grads)
