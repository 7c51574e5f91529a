"""Training: the rate loss, the train and eval steps, the plateau schedule
and the Trainer."""
from .loss import compression_rate_list, rate_distortion_loss, rate_loss_list
from .schedule import ReduceLROnPlateau
from .steps import (apply_gradients, get_learning_rate, make_eval_step,
                    make_optimizer, make_train_step, set_learning_rate)
from .trainer import Trainer, pad_to_multiple
