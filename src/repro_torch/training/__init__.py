"""Port of ``repro.training``: the train step with microbatching and
clipping, the serve steps, and the elastic trainer."""
from .elastic import ElasticState, ElasticTrainer
from .train_loop import accumulate_grads, make_serve_steps, make_train_step

__all__ = ["make_train_step", "make_serve_steps", "accumulate_grads",
           "ElasticTrainer", "ElasticState"]
