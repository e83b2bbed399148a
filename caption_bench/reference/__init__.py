"""Plain PyTorch and NumPy reference of the captioner, in float32.

It imports nothing of the program (``video_caption_tpu_torch``), nothing of
the JAX package and no JAX: it decodes the JPEG files itself, runs the
published architecture on the raw weights, tokenizes the prompts itself,
and judges the ids the program served against its own logits.
"""
