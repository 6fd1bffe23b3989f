from repro_torch.train.optimizer import (OptimizerConfig, apply_updates,
                                         init_state)
from repro_torch.train.trainstep import (chunked_cross_entropy,
                                         make_eval_step, make_loss_fn,
                                         make_train_step, trainable)
from repro_torch.train.loop import LoopConfig, train

__all__ = ["OptimizerConfig", "apply_updates", "init_state",
           "chunked_cross_entropy", "make_eval_step", "make_loss_fn",
           "make_train_step", "trainable", "LoopConfig", "train"]
