"""Host core of the port: read sets, FASTQ/BAM/feudal loading (copied
from w2rap_contigger_tpu/core, jax-free)."""
