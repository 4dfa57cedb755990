"""step_optimizer_ms.train: host time of the train step's ``zero_grad``,
learning rate and ``optimizer.step``, mean a step of the profiled stretch:
the summed inclusive duration of the program's span
``dctseg.trainer.optimizer`` over the stretch's steps.  Read only where the
stretch holds one root span ``dctseg.trainer.step`` a step."""

from benchmark.metrics._spans import TRAIN_ROOT, span_reader

read = span_reader("step_optimizer_ms.train", TRAIN_ROOT,
                   "dctseg.trainer.optimizer")
