"""PyTorch/CUDA port of the NVR paged serving stack.

A second package beside the JAX reference ``repro``: module names mirror
``repro`` so each counterpart is easy to find, but nothing here imports
``jax`` or ``repro`` — modules the port needs are copied, not shared.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
