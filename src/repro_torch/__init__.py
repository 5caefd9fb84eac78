"""PyTorch/CUDA port of the FlowMesh model runtime.

A second package beside the JAX reference: it imports ``torch`` and numpy
only, and is held against the reference by the ``tests/test_torch_*.py``
parity tests. Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU, and raise when no card is present.
"""
