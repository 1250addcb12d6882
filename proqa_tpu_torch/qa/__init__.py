"""Online-retrieval QA data path: the batched sampler and gold-paragraph matching."""
