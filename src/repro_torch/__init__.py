"""PyTorch/CUDA port of the HeMT reproduction.

A second package beside the JAX reference (``src/repro``), with the same
module names. It imports torch and numpy and nothing of the JAX package:
the pure-Python pieces it needs (configs, the speed estimator, the
partitioner) are kept as copies. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; asking for ``cuda`` without a card raises.
"""
