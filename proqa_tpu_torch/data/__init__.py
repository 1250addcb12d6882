"""Host-side data pipeline (document store, datasets, collation, prefetching
loader), copied from proqa_tpu/data so the port imports nothing of the JAX
package."""
