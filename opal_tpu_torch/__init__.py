"""opal_tpu_torch: the PyTorch/CUDA port of opal_tpu.

The particle-in-cell step of ``opal_tpu`` (electrons, ions and
photons; laser, absorbing and conducting boundaries; QED photon
emission, absorption and stimulated emission; the electrostatic field
set-up; checkpoints in ``opal_tpu``'s format; one rank a device over
``torch.distributed``, decomposed or with replicated fields) rebuilt on
PyTorch tensors, with the fused gather + push + deposit kernel written in CUDA
C++ for Hopper (``csrc/fused_push_deposit.cu``).  Module names mirror ``opal_tpu`` so
each counterpart is easy to find; the package imports no JAX and
nothing from ``opal_tpu`` (the two meet only in the tests).
"""

__version__ = "0.1.0"
