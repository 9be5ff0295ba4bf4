"""pilosa_tpu_torch: the PyTorch + CUDA port of the pilosa_tpu bitmap index.

A reduced copy of the JAX package's serving path for Count over
Bitmap / Intersect / Union / Difference trees: roaring storage, the data
model, PQL, the staged device pool and its count kernels (CUDA C++ for
Hopper, under csrc/), the serving layer, the executor and the HTTP API.
Module names follow pilosa_tpu so each counterpart is easy to find; the
package imports torch and never jax or the JAX package.

Every entry point takes an explicit ``device`` and defaults to "cuda".
Asking for cuda without a card raises: nothing falls back to the CPU
quietly. The CPU is used only when the caller passes device="cpu".
"""

from __future__ import annotations

__version__ = "0.1.0"

# Columns per slice (2^20), as in the reference format.
SLICE_WIDTH = 1 << 20


def resolve_device(device="cuda"):
    """The torch device an entry point runs on. Raises RuntimeError for
    a CUDA device when no card is present, rather than running on the
    CPU behind the caller's back."""
    import torch  # here, not at import: ctl server --dry-run needs none

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
