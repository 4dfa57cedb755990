"""engine_input_ms.serve: host time of the engine's copy of the volume to the
card (``Predictor._input``), mean a volume of the profiled stretch: the
summed inclusive duration of the program's span ``dctseg.engine.input`` over
the stretch's volumes.  Read only where the stretch holds one root span
``dctseg.engine.tiled_probs`` a volume."""

from benchmark.metrics._spans import SERVE_ROOT, span_reader

read = span_reader("engine_input_ms.serve", SERVE_ROOT,
                   "dctseg.engine.input")
