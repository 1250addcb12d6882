"""proqa_tpu_torch: the PyTorch / CUDA port of proqa_tpu for an NVIDIA H100.

The JAX package `proqa_tpu` stays the reference; this package mirrors its
module layout, so the counterpart of `proqa_tpu/<path>.py` is
`proqa_tpu_torch/<path>.py`. It imports neither JAX nor anything of
`proqa_tpu`: the framework-free host code it needs (`text/`, `data/`,
`native/`, `train/meta.py`, `utils/logging.py`) is copied here, each copy
naming the module it was taken from.

Layout:
  models/   BERT encoder (dropout, remat), two-tower retriever, JAX-layout
            weight conversion
  ops/      MIPS search, attention, dropout and counter-based random bits;
            hand-written CUDA kernels in csrc/, each beside its plain
            PyTorch version
  index/    device-resident dense index, index building, recall@k
  train/    AdamW with optax's semantics, checkpoints, the retriever trainer
  text/, data/, native/, utils/   host code
  cli/      the `proqa-torch` entry point
"""
