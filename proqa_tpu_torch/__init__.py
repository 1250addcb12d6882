"""proqa_tpu_torch: the PyTorch / CUDA port of proqa_tpu for an NVIDIA H100.

The JAX package `proqa_tpu` stays the reference; this package mirrors its
module layout, so the counterpart of `proqa_tpu/<path>.py` is
`proqa_tpu_torch/<path>.py`. Framework-free host code (`proqa_tpu.text`,
`proqa_tpu.data`) is imported, not copied. This package never imports JAX.

Layout:
  models/   BERT encoder, two-tower retriever, JAX-layout weight conversion
  ops/      MIPS search and attention; hand-written CUDA kernels in csrc/,
            each beside its plain PyTorch version
  index/    device-resident dense index, index building, recall@k
  cli/      the `proqa-torch` entry point
"""
