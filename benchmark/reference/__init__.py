"""The benchmark's plain reference of ClsWiseFormer: plain PyTorch and
NumPy, with no kernel, cache or batching of the program under test.

It imports neither ``jax`` nor the JAX package nor the PyTorch port
(``tests/test_benchmark_harness.py`` checks), and takes nothing the port
made: the weights, the volumes and the dataset files are the benchmark's,
and everything the port derives from them (crops, casts, the loader's batch,
the optimizer state) is worked out here again.

  model.py   the network on its direct path, NDHWC, float32 by default
  loss.py    the training objective with deep supervision
  adam.py    torch's Adam with L2 weight decay and amsgrad, and the poly LR
  loader.py  the loader's arithmetic: NIfTI, z-score, crop, edge map
  counts.py  logical operations and bytes of the configurations' work
"""
