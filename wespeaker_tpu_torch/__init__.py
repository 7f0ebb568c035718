"""wespeaker_tpu_torch: the PyTorch/CUDA port of wespeaker_tpu for NVIDIA
Hopper (H100).

The JAX package `wespeaker_tpu` is the reference; this package keeps its
layout and module names so each counterpart is easy to find, and imports
nothing from it. Plain tensor code is PyTorch; every Pallas kernel of the
reference on a ported path is a CUDA kernel written by hand for `sm_90a`
(`csrc/`, built at first use by `ops/_build.py`).

Conventions:
- activations stay channels-last at public functions: (B, T, F) features,
  (B, T, C) inside ECAPA, exactly as in the JAX package;
- parameters use the upstream torch names and layouts, so an upstream
  wespeaker `.pt` state_dict loads with `load_state_dict`;
- entry points run on `device="cuda"` unless the caller passes
  `device="cpu"`; with no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
