"""Dense index, index building and retrieval evaluation."""
