"""batch_wait_ms.train: host time of the step loop's wait for its next device
batch (``Trainer._device_batches``), mean a step of the profiled stretch:
the summed inclusive duration of the program's span
``dctseg.trainer.batch_wait`` over the stretch's steps.  Read only where the
stretch holds one root span ``dctseg.trainer.step`` a step."""

from benchmark.metrics._spans import TRAIN_ROOT, span_reader

read = span_reader("batch_wait_ms.train", TRAIN_ROOT,
                   "dctseg.trainer.batch_wait")
