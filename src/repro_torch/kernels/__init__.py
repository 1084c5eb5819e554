"""Hand-written Hopper kernels, their builds, wrappers and plain versions.

Each kernel's wrapper launches it on a CUDA tensor (or raises); ``ops``
chooses by the tensor's device and sends a CPU tensor to the plain
PyTorch version in ``ref``.
"""
