"""C++ fast paths of the host text stack (ctypes + g++, built on first use),
copied from proqa_tpu/native."""
