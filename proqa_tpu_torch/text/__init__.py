"""Host-side text stack (tokenizers, answer matching, metrics), copied from
proqa_tpu/text so the port imports nothing of the JAX package."""
