"""video_caption_tpu_torch — the PyTorch/CUDA port of ``video_caption_tpu``.

The JAX package beside it is the reference. This package keeps its module
names, keeps its own copies of the reference's JAX-free modules (config,
datatypes, tokenizer, presets, post-processing, frame loading, the C++
frame loader) and imports nothing of the JAX package. It runs the caption
main path (ViT-B/16 -> mapper -> GPT-2 beam and sampled decode) in PyTorch.
Every Pallas kernel on that path has a hand-written CUDA counterpart under
``ops/csrc/``; each sits beside its plain PyTorch version, which the wrapper
uses for CPU tensors only.
"""

__version__ = "0.1.0"
