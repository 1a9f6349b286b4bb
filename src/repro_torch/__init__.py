"""PyTorch/CUDA port of the SpeedMalloc serving stack (``repro``'s twin).

The package mirrors :mod:`repro` module for module, and holds itself to it:
allocator metadata, grants and counters are bit-identical to the JAX
package on the same inputs; model floats agree within a stated tolerance.
It imports ``torch``, numpy and the standard library only.

Entry points take an explicit ``device`` and default to ``"cuda"``; on a
host without a card they raise unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).  A CUDA tensor reaching a
kernel wrapper launches the hand-written kernel; a CPU tensor runs the
kernel's plain PyTorch version.
"""
