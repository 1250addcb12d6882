"""BERT encoder, two-tower retriever and weight conversion."""
