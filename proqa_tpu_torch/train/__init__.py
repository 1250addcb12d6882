"""Training: AdamW with optax semantics, checkpoints, the retriever trainer."""
