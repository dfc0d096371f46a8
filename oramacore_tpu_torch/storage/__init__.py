"""The port's storage helpers: atomic files, the KV store and the paged
document store (counterparts of `oramacore_tpu/storage/`)."""
