"""Tensor ops of the step: field interpolation, particle push, current
deposition, the Maxwell solver and the fused CUDA kernel."""
